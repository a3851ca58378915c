#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (torchmpi_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

needs one CUDA card and the CUDA toolkit (nvcc), and nothing else of the
JAX package.  In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels from ops/csrc with nvcc (sm_90a, one compiler per
   source, in parallel) into build/torch_kernels/: fourteen kernels in
   seven libraries; beside them, with g++, the parameter server's and the
   async writer's host libraries (torchmpi_tpu_torch/csrc) into
   build/torch_host/;
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
   (all three on wgmma_tf32, the TF32 wgmma product in the three-product
   form: within 1e-4 of the plain float32 versions, bitwise on a repeat,
   each kernel's parent route tf32x3 checked on the same inputs and timed
   in turns with it, the step form on both routes, one float32
   torch.matmul of each product as context); then
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
4. dense train phase (stage B): mpi.init() (NCCL, world of 1), one
   untimed warm-up and eight timed data-parallel SGD steps (lr 0.02;
   median and spread) of the flagship TransformerLM at full
   width and depth (embed 2048, depth 8, GQA 16/4, head_dim 128, T 2048,
   vocab 32768, window 1024, RoPE, bf16 compute, float32 parameters,
   batch 4) with attn_impl="flash" and the dense loss (f32 x @ head);
5. fused train phase (stage B', the main path of the first two slices):
   the same steps with the fused loss, fused_linear_cross_entropy(h.bf16,
   head.bf16, labels); every kernel's launch count must be > 0, every
   launch of the head (forward and backward) on the wgmma route, and the
   loss finite and falling; then the same fused steps at the model's
   default float32 (every launch of the head, forward and backward, on
   wgmma_tf32; one more step's head profiled by part: the forward, the g,
   dx and dW kernels and the backward's K-major copies); in every train
   phase one more, untimed step counts the host-device synchronizations
   of a step, which must be 0, and in the fused ones one more step's
   device time is profiled by part and kernel;
6. consistency phases: one forward and backward of the flagship's seed
   weights and batch with attn_impl="local" (dense oracle) and "flash",
   and with the dense and the fused loss;
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
   statistics (row 11) bitwise equal to the plain ring, 8 timed by CUDA
   events (median and spread of step ms, img/s, peak memory), one
   counting host syncs (0), one
   profiled by part (convolutions, batch norm, ring rows, copies), then a
   ZeRO-1 and a ZeRO-3 step from the same state and batch as a replicated
   one (rows 9 and 10 bitwise equal to the plain ring, ZeRO-1's update
   within 1e-4 of the replicated one), every launch of rows 8 and 11 on
   the 16-byte path (ZeRO's 6,389,258-element shard is not a multiple of
   16 bytes: rows 9 and 10 take their element path there); then the
   planner slice's main path (auto_dp): the same step with no backend
   named under Config(backend="auto") and a plan file of its own, the
   first step measuring each plan key its syncs reach (the stock route
   against rows 8 and 11; the table of medians, jitters and winners
   printed, the ring measured without error), 8 replayed steps with no
   new measurement, the same step in turns with backend "pallas", a
   re-init on the same file bitwise to the per-bucket explicit routes,
   one key on a dcn 2 x ici 2 grid (three candidates), the planner's
   host cost a call, and compat.py on the card;
10. async verbs phase: the nine collective verbs of 4 ranks rank-major
   on the card (float32 at 8,249,691 elements a rank, int32 and bfloat16
   at 300,001; the tiling verbs rounded up to a multiple of 4) against
   their closed forms computed on the CPU, bitwise; staged equal to
   direct; every async handle (direct, on the side stream, and staged)
   equal to its synchronous call; async_.allreduce on the ring bitwise
   equal to the synchronous ring call and launched on the side stream;
   donate=True releasing the input's bytes before wait(); wait_all's
   order and a failed handle (an indivisible scatter) done and raising on
   each wait; the nine process-world verbs and their async_in_axis forms
   over NCCL in the world of one;
11. overlap phase (the main path of the async slice): the ResNet-50 step
   of phase 9 with overlap="auto": the last rank's backward fires each
   reverse-parameter-order bucket (at most 32 MiB) from tensor hooks onto
   the ring (rows 8 and 11) on a side stream; 3 steps with every bucket
   and the statistics bitwise equal to the plain ring, the buckets on the
   side stream; the synced gradients bitwise equal to the plain ring on
   the overlap layout and within 1e-6 (rel. L2) of the non-overlapped
   sync of the same stacks; 8 steps timed by CUDA events in turns with 8
   non-overlapped ones (reported, no bar), one counting host syncs (0),
   one of each profiled by CUDA stream; a ZeRO-1 presynced step within
   1e-4 of a replicated one (row 10 bitwise), a replicated step with 4
   buckets and no overlap, every bucket bitwise; every launch of rows 8
   and 11 on the 16-byte path;
12. FSDP phase (the main path of the FSDP slice): the flagship as FSDP
   of 4 ranks rank-major on the card (recipes.make_fsdp_train_step_rank_major,
   backend "pallas", Adam lr 1e-3, the fused loss): every leaf sharded
   on its largest dim (17 of 116 on dim 1 in torch's layout), gathered
   per leaf on rows 10 / 14, the gradients reduce-scattered as one tree in
   the tile-interleaved layout on rows 9 / 13; a warm-up step and one
   under chunk_bytes 512 MiB checked (every gather and bucket bitwise
   against the plain ring, the fused reduce-scatter against per leaf, the
   update within 1e-4 of replicated Adam), 3 timed by CUDA events, one
   for peak memory, one counting host syncs (0), one profiled by part,
   the layout copies timed alone; persistent bytes a rank <= 0.26 of
   replicated; then the process-world form at world one (NCCL) equal to
   the rank-major form at n = 1;
13. tree verbs phase: collectives_bench.py's 64-leaf float32 / bfloat16
   tree at 1 and 16 MiB, allreduce_in_axis and reduce_scatter_in_axis
   across the NCCL world of one and the rank-major fused reduce-scatter of
   4 ranks on "pallas", per leaf (64 launches) and fused (2), bitwise
   equal, timed;
14. bus-bandwidth phase: the allreduce (rows 11 / 12 at 64 KiB-16 MiB,
   8 / 7 at 64 MiB a rank, and the stock route) and the allgather (rows
   14 / 10, stock) of 4 ranks rank-major, ms, algbw and busbw
   (collectives_bench.py's formulas), each against the plain ring; the
   hops are device copies on one card;
15. two-level phase (hier_dp, the main path of the two-level slice):
   ResNet-50 of phase 9 with its 4 ranks as a dcn 2 x ici 2 grid,
   backend "hierarchical", int8 error feedback, the ring per node;
16. parameter-server phase (downpour_ps, the main path of the
   parameter-server slice): BASELINE config 4, AlexNet async downpour at
   full width (224 x 224, 1000 classes, 62,378,344 float32 parameters, a
   249.5 MB flat vector), 2 worker threads on their own streams sharing
   one client of a 4-shard server, batch 128 a worker, Adam lr 3e-4, axpy
   pushes at alpha 1/2, a fetch every 5 steps adopted a step later;
   checks (a)-(e) first (three pushes of one worker equal to a numpy
   float32 fold, bitwise; receive() bitwise on the card; two pushes back
   to back and two threads' pushes their bitwise sums; an elastic
   exchange equal to the server's formula in numpy), then a warm-up step,
   10 timed steps a worker with nothing watching (img/s, step ms, the
   push and fetch split, the server's cycle costs; peak memory; no kernel
   of the table), 5 watched (the card's busy share, torch.profiler over
   the window; host syncs: one event wait a push, none else) and 2 while
   checkpoint.save_async writes a fresh
   center and worker 0's Adam state (f: restored bitwise after; write
   seconds and MB/s);
17. examples phase: the port's mnist_sequential, mnist_allreduce,
   cifar_resnet20 (ZeRO 0 and 3) and mnist_async_allreduce (4 buckets in
   the world of one; overlapped, 4 ranks rank-major on the ring), then
   mnist_downpour, mnist_easgd, alexnet_downpour (their defaults) and
   checkpoint_resume in-process on the card, each to its bar (MNIST >
   0.9, CIFAR > 0.85, AlexNet > 2 / 10, the resumed run's final loss
   below its loss at the crash);
18. prints the kernels' summary line (each kernel's launches summed over
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
BATCH, SEQ, LR = 4, 2048, 0.02
# An LM train phase: one untimed warm-up step, then TIMED_STEPS on the
# host's clock (median and spread: three steps could not tell a 4% change
# from the spread on an untouched path).
TIMED_STEPS = 8
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
# operands (the wgmma_tf32 and tf32x3 routes) g is not rounded and the
# three-product form keeps f32's accuracy, so dx / dW are held as loss and
# lse are.
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
# The float32 head's route per kernel: all three on the TF32 wgmma
# product (PERF.md rows 4 f32, 5 f32, 6 f32).
XENT_F32_ROUTES = {"xent_fwd": "wgmma_tf32", "xent_bwd_dx": "wgmma_tf32",
                   "xent_bwd_dw": "wgmma_tf32"}
# The float32 head's recorded tf32x3 times (PERF.md's kernel table, the
# same shapes and time_ms); the phase also times that route in this run.
XENT_F32_RECORDED_MS = {"xent_fwd": 41.837, "xent_bwd_dx": 77.314,
                        "xent_bwd_dw": 75.352}
# The float32 head's kernels in a step's profile: the first pattern a
# kernel's name matches names its part.  The forward's copies write W^T
# and its lo part (tf32_split_kernel<false, true>) and x's lo part
# (<true, false>); the step's backward wants dx and dW, so its copies
# write all three (<true, true>).
XENT_F32_PARTS = (
    ("forward (StatF32Epi, merge, its copies)",
     r"StatF32Epi|xent_fwd_merge_kernel|"
     r"tf32_split_kernel<(false, true|true, false)>"),
    ("g (GradF32Epi)", r"GradF32Epi"),
    ("dx (DxF32Epi)", r"DxF32Epi"),
    ("dW (DwF32Epi)", r"DwF32Epi"),
    ("K-major copies (tf32_split_kernel)", r"tf32_split_kernel"),
    ("tf32x3 forward (xent_fwd_kernel<float>)", r"xent_fwd_kernel<float>"),
    ("tf32x3 backward (xent_grad / dx / dw_kernel<float>)",
     r"xent_(grad|dx|dw)_kernel<float>"),
)
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
R50_CHECKED_STEPS = 3
R50_TIMED_STEPS = 8  # median and spread (the step spreads 148-327 ms)
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
# The same for an LM step: the port's kernels (the head's in namespaces
# tmw / tmx), then cuBLAS's products (the projections and the MLP; its
# Hopper kernels are named nvjet_* or *gemm*), then the rest.
LM_STEP_PARTS = (
    ("flash kernels", r"flash_\w*kernel"),
    ("fused-loss head", r"tmw::|tmx::|xent_"),
    ("matmuls (cuBLAS)", r"nvjet|gemm|xmma|cutlass|cublas"),
    ("copies and casts", r"copy|Copy|Memcpy|CatArray|cat_"),
    ("reductions", r"reduce"),
    ("elementwise", r"elementwise|vectorized"),
)
# The examples run in-process, a world of one on the card, to their
# accuracy bars (MNIST > 0.9, CIFAR > 0.85; each raises below it).
# (example, argv, bar, Config knobs set around the run): the async example
# bucketed (a world of one on NCCL, 4 buckets) and overlapped (4 ranks
# rank-major on the ring, the buckets fired from the backward hooks).
CNN_EXAMPLES = (("mnist_sequential", (), 0.9, {}),
                ("mnist_allreduce", (), 0.9, {}),
                ("cifar_resnet20", ("--zero", "0"), 0.85, {}),
                ("cifar_resnet20", ("--zero", "3"), 0.85, {}),
                ("mnist_async_allreduce", (), 0.9, {}),
                ("mnist_async_allreduce", ("--devices", "4", "--backend",
                                           "pallas"), 0.9,
                 {"gradsync_overlap": "auto"}))
# The async slice: ASYNC_N ranks rank-major on the card, float32 at the
# flagship's gradient bucket and int32 / bfloat16 at 300,001 elements a
# rank (the verbs that tile a rank's tensor over the ranks, rounded up to
# a multiple of ASYNC_N); each verb's parameters.
ASYNC_N = 4
ASYNC_SIZES = {"float32": RING_BUCKET, "int32": RING_SMALL,
               "bfloat16": RING_SMALL}
ASYNC_TILED = ("reduce_scatter", "scatter", "alltoall")
ASYNC_PARAMS = {"allreduce": {"op": "sum"}, "broadcast": {"root": 1},
                "reduce": {"root": 2, "op": "mean"}, "allgather": {},
                "reduce_scatter": {}, "gather": {"root": 3},
                "scatter": {"root": 1}, "sendreceive": {"src": 3, "dst": 0},
                "alltoall": {}}
WORLD_VERBS = ("reduce", "gather", "scatter", "sendreceive", "alltoall")
# The overlap slice: ResNet-50 as resnet50_dp runs it, the sync fired from
# the backward hooks (overlap="auto"): reverse-parameter-order buckets of
# at most overlap_bucket_bytes (32 MiB, fuse_max_bytes' power of two), the
# allreduces of the last rank's backward on a side stream; rows 8 and 11
# from the hooks, 11 also for the statistics, 10 for the ZeRO-1
# (presynced) all-gather.
OV_ROWS = ("ring_allreduce_chunked", "ring_all_gather_chunked",
           "ring_allreduce")
OV_VECTOR_ROWS = ("ring_allreduce_chunked", "ring_allreduce")
OV_FUSED_RTOL = 1e-6  # overlap layout vs the 32 MiB fused layout, rel. L2
# The FSDP slice: the flagship as FSDP of RING_N ranks rank-major with Adam
# (lr 1e-3, as zero_dp): every leaf of the flagship divides by 4, so all
# 116 are sharded (kv, mlp_out and head on dim 1 in torch's layout).  One
# untimed warm-up step and one under the resident chunk_bytes are checked
# (every gather and reduce-scatter bucket against the plain ring, the
# fused reduce-scatter against per leaf); FSDP_TIMED_STEPS between them
# are timed.  Persistent bytes a rank (parameters, Adam's moments) against
# replicated: 0.25 with every leaf sharded.
FSDP_ROWS = ("ring_reduce_scatter_chunked", "ring_all_gather_chunked",
             "ring_reduce_scatter", "ring_all_gather")
FSDP_TIMED_STEPS = 3
FSDP_PERSISTENT_MAX = 0.26
FSDP_STEP_PARTS = (("ring rows", r"ring_direct"),) + LM_STEP_PARTS
# The tree verbs: collectives_bench.py's _pytree_mode tree (:79-87): 64
# leaves alternating float32 and bfloat16, max(8, bytes / 64 / 4) elements
# each, at two of its sizes.
TREE_LEAVES = 64
TREE_SIZES = (1_048_576, 16_777_216)
# The bus-bandwidth table (collectives_bench.py :808-947): 4 ranks'
# buffers on the one card, so a "hop" is a copy in device memory.
BUSBW_SIZES = (65_536, 1_048_576, 16_777_216, 67_108_864)
BUSBW_HOPS = "device copies on one card, not NVLink"
BUSBW_ROWS = ("ring_allreduce_chunked", "ring_allreduce_bidir_chunked",
              "ring_allreduce", "ring_allreduce_bidir")
BUSBW_STOCK_RTOL = 1e-5  # the stock left fold vs the ring's add order
# The two-level slice: BASELINE config 5 (multi-slice ResNet-50, the
# hierarchical allreduce): resnet50_dp's model, batch and optimizer, its
# R50_N ranks as a HIER_DCN x R50_N / HIER_DCN (dcn x ici) grid on the one
# card, so both levels are device copies, not NVLink or a network.
# (a) backend "hierarchical" under the default dcn_chunk_bytes (4 MiB: the
# 4 fused buckets' 12.8 MB ici shards run in 4 chunks): every sync bitwise
# to the same call unchunked and within HIER_FLAT_RTOL (rel. L2) of the
# flat stock allreduce; (b) HIER_EF_SYNCS int8 error-feedback syncs of one
# step's gradient stacks, each bitwise to the plain composition and within
# the codec's bound; (c) backend "pallas" on the grid (rows 8 and 11 per
# node, rows 9 and 10 under ZeRO); (d) the NCCL world of one warning once.
HIER_DCN = 2
HIER_CHECKED_STEPS = 3
HIER_TIMED_STEPS = 8
HIER_FLAT_RTOL = 1e-6
HIER_EF_SYNCS = 3
HIER_CHUNKS = 4
HIER_LEGS = ("hier/ici_reduce_scatter", "hier/dcn_allreduce",
             "hier/ici_all_gather")
HIER_ROWS = R50_ROWS
HIER_HOPS = "device copies on one card, not NVLink or a network"
# The planner / tuning slice: resnet50_dp's ResNet-50 step under
# Config(backend="auto") and a plan file of the phase's own: the first
# step measures every (op, size bucket) its syncs reach (the 4 gradient
# buckets' key and the BatchNorm statistics' key: "xla" against the ring,
# "pallas"), the next AUTO_TIMED_STEPS replay the plans; then a re-init
# from the same file, one allreduce key of AUTO_GRID_ELEMS float32 a rank
# on a dcn 2 x ici 2 grid ("hierarchical" a candidate too), the planner's
# host cost per call of a rank-major "pallas" allreduce at RING_SMALL a
# rank (AUTO_HOST_CALLS calls a turn, planned and unplanned in turns), and
# the compat surface.
AUTO_TIMED_STEPS = 8
# Steps of the replayed plans and of the same step on backend "pallas"
# (resnet50_dp's routes), in turns.
AUTO_TURNS = ("auto", "pallas", "pallas", "auto") * 4
AUTO_GRID_ELEMS = 1_048_576
AUTO_HOST_CALLS = 200
AUTO_HOST_TURNS = (True, False, False, True, True, False, False, True)
AUTO_ROWS = ("ring_allreduce_chunked", "ring_allreduce")
# The parameter-server slice: BASELINE config 4 (AlexNet async downpour,
# examples/alexnet_downpour.py's full configuration): AlexNet at 224 x 224,
# 1000 classes, dropout 0, float32, 62,378,344 parameters (a 249.5 MB flat
# vector), PS_WORKERS worker threads on their own streams sharing one
# client, PS_BATCH images a worker, PS_SHARDS shards, Adam lr PS_LR a
# worker, pushes with the axpy rule at alpha 1 / PS_WORKERS, a fetch every
# PS_FETCH_EVERY steps adopted one step later.  The data:
# synthetic_image_classification(PS_IMAGES) at 224 x 224 x 3, 616 MB on
# the host, copied to the card once.  Segments of steps a worker: one
# untimed warm-up, PS_TIMED_STEPS timed (nothing watching), PS_PROBE_STEPS
# (one whole fetch period) under torch.profiler for the card's busy share
# and under the sync debug mode and an event-wait count for the host
# syncs, PS_CKPT_STEPS while a checkpoint of the center and worker 0's
# Adam state is written.  The server is host threads behind loopback TCP
# on the card's machine.
PS_WORKERS, PS_SHARDS, PS_BATCH = 2, 4, 128
PS_IMAGE, PS_CLASSES, PS_IMAGES = 224, 1000, 1024
PS_LR, PS_FETCH_EVERY = 3e-4, 5
PS_PARAMS = 62_378_344
PS_TIMED_STEPS, PS_PROBE_STEPS, PS_CKPT_STEPS = 10, PS_FETCH_EVERY, 2
PS_CHECK_PUSHES = 3
PS_ELASTIC_ALPHA = 0.3
PS_TRANSPORT = "loopback TCP to server threads on the same host"
# The parameter-server and checkpoint examples, in-process on the card at
# their defaults, to their bars: (example, argv, bar); checkpoint_resume's
# bar is its own (the resumed run's final loss below its loss at the
# crash, raised inside main).
PS_EXAMPLES = (("mnist_downpour", (), 0.9), ("mnist_easgd", (), 0.9),
               ("alexnet_downpour", (), 2.0 / 10),
               ("checkpoint_resume", (), None))

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
            epi = re.search(r"gemm_kernelI\w*?\d([A-Z][a-z][A-Za-z0-9]*Epi)E",
                            m.group(1))
            tf32 = re.search(r"gemm_tf32_kernelI\w*?\d([A-Z][A-Za-z0-9]*Epi)E",
                             m.group(1))
            key = (f"D{d.group(1)}" if d else
                   f"wgmma_tf32<{tf32.group(1)}>" if tf32 else
                   f"wgmma<{epi.group(1)}>" if epi else
                   "tf32_split_kernel" if "tf32_split_kernel" in m.group(1)
                   else name.group(0) if name else m.group(1))
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


class forced_route:
    """Within the block, every float32 call of ``xent`` takes ``route``:
    the parent's tf32x3 route timed beside the new one on the same inputs
    (a measurement here; the port always takes ``xent._route``'s)."""

    def __init__(self, torch, xent, route):
        self.torch, self.xent, self.route = torch, xent, route

    def __enter__(self):
        real = self.real = self.xent._route

        def route(*a, dtype):
            return (self.route if dtype == self.torch.float32
                    else real(*a, dtype=dtype))

        self.xent._route = route

    def __exit__(self, *exc):
        self.xent._route = self.real


def xent_f32_phase(torch, xent, dev):
    """Rows 4, 5 and 6 on float32 operands at the flagship's LM-head shapes,
    all three on wgmma_tf32 (the TF32 wgmma product in the three-product
    form); each kernel against its plain float32 version on the same
    inputs and a repeat call, every launch on its route, and the forward's
    and the backward's K-major copies (tf32_split_kernel) bitwise to the
    plain split; then each kernel's parent route, tf32x3, on the same
    inputs, checked as well; the two routes timed in turns (wgmma_tf32,
    tf32x3, tf32x3, wgmma_tf32), beside the plain version, the bound (the
    function's operations at TF32 peak), the three-product floor
    (`issued_flops`, three times that, at TF32 peak) and, as context, one
    float32 torch.matmul (no TF32) of each product; and the backward as
    the step runs it (xent_bwd, g once per chunk) on both routes."""
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

    def check_run(name, kern, plain):
        out, again = kern(), kern()
        ref = plain()
        out, again, ref = ((t,) if torch.is_tensor(t) else t
                           for t in (out, again, ref))
        torch.cuda.synchronize()
        rtol = XENT_STAT_RTOL if name == "xent_fwd" else XENT_F32_GRAD_RTOL
        return {"all_errs": [(max_err(a, r), rtol * float(
                    r.float().abs().max())) for a, r in zip(out, ref)],
                "bitwise_repeat": all(torch.equal(a, b)
                                      for a, b in zip(out, again)),
                "out_dtypes": sorted({str(t.dtype) for t in out})}

    # Every kernel on its own route first: those launches are counted.
    checks = {name: check_run(name, kern, plain)
              for name, (kern, plain) in runs.items()}
    torch.cuda.synchronize()
    counts = {n: {r: c[r] - before[n][r] for r in c}
              for n, c in xent.ROUTE_LAUNCHES.items()}
    # The wgmma_tf32 route's K-major copies (tf32_split_kernel): the
    # backward's of W, then the forward's of W and x, against the plain
    # split, bit for bit.
    ops = dict(zip(xent.TF32_OPS, xent._tf32_workspace(
        w, min(xent.TF32_CHUNK, N), True, True)))
    w_lo = xent.tf32_split_plain(w)[1]
    split_bitwise = (torch.equal(ops["wt"], w.t())
                     and torch.equal(ops["wt_lo"], w_lo.t())
                     and torch.equal(ops["w_lo"], w_lo))
    del ops
    x_lo, wt, wt_lo = xent._fwd_tf32_copies(x, w)
    split_bitwise = split_bitwise and (
        torch.equal(wt, w.t()) and torch.equal(wt_lo, w_lo.t())
        and torch.equal(x_lo, xent.tf32_split_plain(x)[1]))
    del x_lo, wt, wt_lo, w_lo
    rows, parent = [], {}
    for name, (kern, plain) in runs.items():
        res = checks[name]
        flops, nbytes = work[name]
        t_op = flops / PEAK_TF32_FLOPS * 1e3
        t_b = nbytes / PEAK_HBM_BYTES * 1e3
        row = {
            "name": f"{name}[{XENT_F32_ROUTES[name]}]", "route": "cuda",
            "source": SOURCES[name][0], "replaces": SOURCES[name][1],
            "max_abs_err": max(e for e, _ in res["all_errs"]),
            "tolerance": max(t for _, t in res["all_errs"]), **res,
            "plain_ms": time_ms(torch, plain),
            "bound_ms": max(t_op, t_b),
            "bound_by": "operations" if t_op >= t_b else "bytes",
            "three_product_floor_ms": 3 * t_op,
            "library_ms": None, "flops": flops, "issued_flops": 3 * flops,
            "bytes": nbytes,
            "matmul_ms": {p: matmul_ms[p] for p in products[name]}}
        # The parent's route on the same inputs: checked, then the two
        # routes timed in turns.
        with forced_route(torch, xent, "tf32x3"):
            parent[name] = check_run(name, kern, plain)
        turns = {"wgmma_tf32": [], "tf32x3": []}
        for route in ("wgmma_tf32", "tf32x3", "tf32x3", "wgmma_tf32"):
            with forced_route(torch, xent, route):
                turns[route].append(time_ms(torch, kern, iters=5))
        row.update(ms=statistics.median(turns["wgmma_tf32"]),
                   turns_ms=turns,
                   tf32x3_ms=statistics.median(turns["tf32x3"]),
                   earlier_ms=XENT_F32_RECORDED_MS[name],
                   tf32x3_check=parent[name])
        rows.append(row)
    # The backward as the float32 step runs it: g once per chunk, on both
    # routes in turns; bound and floor of its three products.
    step = {"wgmma_tf32": [], "tf32x3": []}
    for route in ("wgmma_tf32", "tf32x3", "tf32x3", "wgmma_tf32"):
        with forced_route(torch, xent, route):
            step[route].append(time_ms(
                torch, lambda: xent.xent_bwd(x, w, labels, lse, dl),
                iters=5))
    step_form = {"name": "xent_bwd", "what": "g once per chunk, dx and dW",
                 "turns_ms": step,
                 "ms": statistics.median(step["wgmma_tf32"]),
                 "tf32x3_ms": statistics.median(step["tf32x3"]),
                 "bound_ms": 6 * N * E * V / PEAK_TF32_FLOPS * 1e3,
                 "three_product_floor_ms":
                     18 * N * E * V / PEAK_TF32_FLOPS * 1e3}
    # The K-major copies' bytes a call of the step form at TF32_CHUNK rows:
    # W^T, its lo part and W's (once a call); x's lo part, x^T and its lo
    # part, g's lo part, g^T and its lo part (one chunk's, reused); and a
    # forward's: W^T, its lo part and x's lo part.
    C = min(xent.TF32_CHUNK, N)
    copies = {"per_call": 3 * E * V * 4,
              "per_chunk": (3 * C * E + 3 * C * V) * 4,
              "forward_per_call": (2 * E * V + N * E) * 4}
    emit({"phase": "xent_f32", "shape": dict(N=N, E=E, V=V, dtype="float32",
                                             bwd_chunk=xent.BWD_CHUNK,
                                             tf32_chunk=xent.TF32_CHUNK),
          "route_launches_in_checks": counts, "kernels": rows,
          "step_form": step_form, "copy_bytes": copies,
          "split_bitwise": split_bitwise})
    check(split_bitwise, "tf32_split_kernel's copies of W or x differ "
          "from the plain split")
    for name, c in counts.items():
        route = XENT_F32_ROUTES[name]
        check(c[route] > 0 and c[route] == sum(c.values()),
              f"{name} on float32 operands off the {route} route: {c}")
    for row in rows:
        check(row["max_abs_err"] <= row["tolerance"],
              f"{row['name']} max_abs_err {row['max_abs_err']} > "
              f"{row['tolerance']}")
        check(row["bitwise_repeat"], f"{row['name']}: two calls differ")
        check(row["out_dtypes"] == ["torch.float32"],
              f"{row['name']}: outputs {row['out_dtypes']}")
    for name, res in parent.items():
        check(all(e <= t for e, t in res["all_errs"])
              and res["bitwise_repeat"],
              f"{name}[tf32x3] on the same inputs: {res}")
    return rows


def head_f32_profile(torch, fn) -> dict:
    """The float32 head's device time in one call of ``fn`` (a step) by
    part (XENT_F32_PARTS), from torch.profiler."""
    parts = {}
    for key, calls, ms in profile_rows(torch, fn):
        for part, pat in XENT_F32_PARTS:
            if re.search(pat, key):
                p = parts.setdefault(part, {"ms": 0.0, "calls": 0})
                p["ms"] += ms
                p["calls"] += calls
                break
    return {"parts": parts, "head_ms": sum(p["ms"] for p in parts.values())}


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
    the wgmma_tf32 route), through the fused linear + cross-entropy
    kernels, mean over the next tokens."""
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


def flagship(torch, mpi, dev, dtype):
    """The flagship TransformerLM (flash attention, compute ``dtype``) at
    its seed weights, and its batch of tokens."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    model = mpi.models.TransformerLM(**LM, attn_impl="flash", dtype=dtype,
                                     device=dev, generator=g)
    tok = torch.randint(0, LM["vocab"], (BATCH, SEQ), generator=g,
                        device=dev)
    return model, tok


def train_phase(torch, mpi, ops, dev, loss: str, dtype=None):
    """One untimed warm-up and TIMED_STEPS timed DP steps of the flagship
    with the ``loss`` of LOSSES at compute ``dtype`` (bf16 by default),
    reported as their median and spread; every kernel counter is set to 0
    just before and read just after.  With the fused loss every launch of
    the head must take the route of ``dtype``: wgmma for bf16, wgmma_tf32
    for float32, whose head's device time by part one more step's profile
    reports; and one more step's device time by part and kernel
    (step_profile)."""
    dtype = dtype or torch.bfloat16
    model, tok = flagship(torch, mpi, dev, dtype)
    n_params = sum(p.numel() for p in model.parameters())
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    loss_fn = LOSSES[loss]
    step = mpi.nn.data_parallel_step(
        model, opt, lambda m, t: loss_fn(torch, mpi, m, t, dtype))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in ops.values():
        mod.reset_launches()
    losses, step_ms = [], []
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        loss_v = step(tok)
        losses.append(float(loss_v))  # waits for the step
        if i:  # the first is the warm-up
            step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {n: c for mod in ops.values() for n, c in mod.LAUNCHES.items()}
    routes = {n: dict(c) for n, c in ops["xent"].ROUTE_LAUNCHES.items()}
    med = statistics.median(step_ms)
    peak = torch.cuda.max_memory_allocated()
    # One more, untimed step: how often a step makes the host wait for the
    # card (each wait drains the queue of work the host had run ahead on).
    syncs = count_host_syncs(torch, lambda: step(tok))
    f32_head = (head_f32_profile(torch, lambda: step(tok))
                if loss == "fused" and dtype == torch.float32 else None)
    profile = (step_profile(torch, lambda: step(tok),
                            step_parts=LM_STEP_PARTS)
               if loss == "fused" else None)
    emit({"phase": "train", "loss": loss,
          "config": dict(LM, batch=BATCH, seq=SEQ, lr=LR,
                         dtype=str(dtype).split(".")[-1]),
          "params": n_params, "losses": losses, "warmup_steps": 1,
          "step_ms": step_ms, "median_step_ms": med,
          "min_step_ms": min(step_ms), "max_step_ms": max(step_ms),
          "tokens_per_s": BATCH * SEQ / (med / 1e3),
          "peak_mem_bytes": peak, "host_syncs_per_step": syncs,
          "launches": launches, "xent_route_launches": routes,
          **({"head_device_profile": f32_head} if f32_head else {}),
          **({"step_device_profile": profile} if profile else {}),
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
        for name, counts in routes.items():
            route = (XENT_F32_ROUTES[name] if dtype == torch.float32
                     else "wgmma")
            check(counts == {r: launches[name] * (r == route)
                             for r in ops["xent"].ROUTES},
                  f"{name}: stage B' head launches off the {route} route: "
                  f"{counts} of {launches[name]}")
    return launches, routes


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


def consistency_phase(torch, mpi, dev):
    """The flagship's seed weights and batch (those every train phase
    starts from, so the comparison does not depend on how many steps a
    train phase takes) through attn_impl "flash" vs "local" (dense loss),
    and through the fused vs the dense loss (flash attention)."""
    model, tok = flagship(torch, mpi, dev, torch.bfloat16)
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
    route launched, its elements a rank, the stream it ran on, and the peak
    device memory while
    the route ran (the peak so far is kept in ``log.peak``).  While
    ``log.check`` is False the calls are timed and not compared (their
    ``bitwise`` is None).  Returns the function that restores the plain
    routes."""
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
                     "stream": torch.cuda.current_stream().cuda_stream,
                     "rows": [k for k, v in ring.LAUNCHES.items()
                              if v != before[k]],
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "bitwise": (torch.equal(out, plain(xs, **kw))
                                 if log.check else None)}
            if verb == "all_gather" and log.check:
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
    check = True  # compare each call with the plain ring (else time only)


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


def step_profile(torch, fn, top: int = 15, step_parts=STEP_PARTS) -> dict:
    """Device time of one call of ``fn`` (torch.profiler) by part of the
    step (``step_parts``: the first pattern a kernel's name matches) and
    the ``top`` largest kernels with their call counts."""
    rows = profile_rows(torch, fn)
    parts = {name: {"ms": 0.0, "calls": 0} for name, _ in step_parts}
    parts["other"] = {"ms": 0.0, "calls": 0}
    for key, calls, ms in rows:
        part = next((name for name, pat in step_parts
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
    bitwise to the plain ring on the same stacks; R50_TIMED_STEPS more
    timed by CUDA events (median and spread); one counting the host
    syncs; one profiled by part; then one
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
          "min_step_ms": min(step_ms), "max_step_ms": max(step_ms),
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

def auto_dp_phase(torch, mpi, ops, dev):
    """This slice's main path: resnet50_dp's ResNet-50 step (R50_N ranks
    rank-major, R50_BATCH images a rank, SGD) with no backend named, under
    Config(backend="auto", tuning_plan_path=<a file of its own>).

    (a) Step 1 measures every plan key the step's syncs reach: each key's
    candidate medians and jitters, and the winner, are printed; "pallas"
    must have been measured without an error on every key (the decision
    log holds no ``errors``).  (b) Steps 2 to 1 + AUTO_TIMED_STEPS replay
    the plans: no new measurement, the planner's hits grow; the step ms by
    CUDA events (median, min, max).  Every kernel counter is set to 0 just
    before step 1 and read after the last.  Then AUTO_TURNS: the replayed
    step in turns with the same step on backend "pallas" (resnet50_dp's
    routes), each step's time by CUDA events and the host time until the
    step returns, and one replayed step's device time by part (no claim
    on either).  (c) stop / init on the same
    plan file, then one step (cuDNN deterministic): no measurement, and
    its parameters, momentum, statistics and loss bitwise equal to the
    same step with each sync bucket run under the explicit backend its
    plan chose.  (d) One allreduce key on a dcn 2 x ici 2 grid: three
    candidates, "hierarchical" among them, none failing; the call bitwise
    equal to its winner's.  (e) The planner's host cost: host us per call
    of a planned and an unplanned rank-major "pallas" allreduce at
    RING_SMALL a rank, in turns (no claim).  (f) compat.py on the card.
    The runtime is restarted with the default Config at the end."""
    import shutil
    import tempfile

    import torchmpi_tpu_torch.compat as compat
    from torchmpi_tpu_torch.utils import data as dutil
    from torchmpi_tpu_torch.utils.input_pipeline import prefetch_to_device

    ring = ops["ring"]
    recipes, fusion, gs = mpi.recipes, mpi.fusion, mpi.parallel.gradsync
    tuning, planner, sel = mpi.tuning, mpi.planner, mpi.selector
    n, b = R50_N, R50_BATCH
    plan_dir = tempfile.mkdtemp(prefix="tm_plans_")
    cfg = mpi.Config(backend="auto",
                     tuning_plan_path=os.path.join(plan_dir, "plans.json"))
    mpi.stop()
    dev = mpi.init(cfg)
    try:
        g = torch.Generator(device=dev).manual_seed(SEED + 8)
        model = mpi.models.ResNet50(num_classes=R50_CLASSES,
                                    dtype=torch.bfloat16, device=dev,
                                    generator=g)
        params, stats = recipes.bn_state(model)
        tx = mpi.optim.sgd(R50_LR, momentum=R50_MOMENTUM)
        opt = [tx.init(p) for p in params]
        step = recipes.make_bn_dp_train_step_rank_major(model, tx, n)
        X, Y = dutil.synthetic_image_classification(
            2 * n * b, image_shape=(R50_IMAGE, R50_IMAGE, 3),
            num_classes=R50_CLASSES, seed=SEED)
        it = prefetch_to_device(dutil.batches(
            X, Y, n * b, steps=AUTO_TIMED_STEPS + len(AUTO_TURNS) + 3,
            seed=SEED), depth=2, device=dev)

        def batch():
            xb, yb = next(it)
            return xb.permute(0, 3, 1, 2), yb

        grid = sel.grid_of(n, dev)
        spec = fusion.FusedSpec(params)
        want_keys = {tuning.make_fingerprint("allreduce", (hi - lo) * 4,
                                             torch.float32, grid)
                     for gr in spec.groups for lo, hi in gr.bounds}
        want_keys.add(tuning.make_fingerprint("allreduce", R50_STATS * 4,
                                              torch.float32, grid))
        tuning.reset_measurement_count()
        n_dec = len(tuning.decisions())
        losses = []
        torch.cuda.synchronize()
        for mod in ops.values():
            mod.reset_launches()
        # (a) step 1: the measurements.
        xb, yb = batch()
        t0 = time.perf_counter()
        params, opt, stats, loss = step(params, opt, stats, xb, yb)
        losses.append(loss)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        measured = tuning.measurement_count()
        decisions = tuning.decisions()[n_dec:]
        table = []
        for d in decisions:
            if d.get("source") != "measured":
                continue
            e = tuning.plan().get(d["key"])
            table.append({"key": d["key"], "median_ms": e.median_ms,
                          "jitter_ms": e.jitter_ms, "winner": e.backend,
                          "gated_to_default": d["evidence"].get(
                              "gated_to_default")})
        errors = [d for d in decisions if d.get("errors")]
        # (b) the replayed steps.
        hits0 = planner.stats()["hits"]
        step_ms = []
        for _ in range(AUTO_TIMED_STEPS):
            xb, yb = batch()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt, stats, loss = step(params, opt, stats, xb, yb)
            end.record()
            end.synchronize()
            losses.append(loss)
            step_ms.append(start.elapsed_time(end))
        launches = {k: ring.LAUNCHES[k] for k in AUTO_ROWS}
        vector = {k: {"all": ring.LAUNCHES[k],
                      "vector": ring.VECTOR_LAUNCHES[k]} for k in AUTO_ROWS}
        replay_hits = planner.stats()["hits"] - hits0
        replay_measured = tuning.measurement_count() - measured
        rows = [r for r in planner.describe() if r["kind"] == "gradsync"]
        plan_rows = [{k: r[k] for k in ("op", "backends", "nbytes", "hits",
                                        "build_ms", "topology")}
                     for r in rows]
        step_ring = recipes.make_bn_dp_train_step_rank_major(
            model, tx, n, backend="pallas")
        turns = {"auto": [], "pallas": []}
        turns_host = {"auto": [], "pallas": []}
        for name in AUTO_TURNS:
            xb, yb = batch()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            params, opt, stats, loss = (step if name == "auto" else
                                        step_ring)(params, opt, stats, xb,
                                                   yb)
            turns_host[name].append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            losses.append(loss)
            turns[name].append(start.elapsed_time(end))
        xb, yb = batch()
        profile = step_profile(torch, lambda: step(params, opt, stats, xb,
                                                   yb))

        # (c) a new runtime on the same plan file.
        xb, yb = batch()
        mpi.stop()
        dev = mpi.init(cfg)
        tuning.reset_measurement_count()
        torch.backends.cudnn.deterministic = True
        fused = fusion.fused_allreduce_rank_major_
        synced = gs.synchronize_gradients_rank_major
        try:
            got = step(params, opt, stats, xb, yb)
            reinit_measured = tuning.measurement_count()
            chosen = {r["nbytes"]: r["backends"] for r in planner.describe()
                      if r["kind"] == "gradsync"}

            def explicit(stacks, op):
                backends = chosen[sum(t[0].numel() * t.element_size()
                                      for t in stacks)]
                fused(stacks, spec=fusion.FusedSpec([t[0] for t in stacks]),
                      impls=[sel.select("allreduce_rank_major", bk, ranks=n)
                             for bk in backends], op=op)

            gs.synchronize_gradients_rank_major = \
                lambda stacks, **kw: explicit(stacks, "mean")
            fusion.fused_allreduce_rank_major_ = \
                lambda stacks, op="sum", **kw: explicit(stacks, op)
            ref = step(params, opt, stats, xb, yb)
        finally:
            gs.synchronize_gradients_rank_major = synced
            fusion.fused_allreduce_rank_major_ = fused
            torch.backends.cudnn.deterministic = False
        reinit_bitwise = (
            all(torch.equal(a, c) for a, c in zip(got[0], ref[0]))
            and all(torch.equal(a.trace, c.trace)
                    for a, c in zip(got[1], ref[1]))
            and all(torch.equal(a, c) for a, c in zip(got[2], ref[2]))
            and torch.equal(got[3], ref[3]))

        # (d) one allreduce key on the dcn 2 x ici 2 grid.
        mpi.set_config(dcn_size=HIER_DCN)
        xs = torch.randn(n, AUTO_GRID_ELEMS, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             SEED + 20))
        n_dec = len(tuning.decisions())
        y = mpi.allreduce_rank_major(xs)
        (grid_dec,) = [d for d in tuning.decisions()[n_dec:]
                       if d.get("source") == "measured"]
        grid_entry = tuning.plan().get(grid_dec["key"])
        grid_bitwise = torch.equal(y, mpi.allreduce_rank_major(
            xs, backend=grid_entry.backend))
        stock = mpi.collectives._stock_allreduce_rank_major(xs)
        grid_rel = float((y - stock).norm() / stock.norm())
        mpi.set_config(dcn_size=None)

        # (e) the planner's host cost per call.
        xs = torch.randn(n, RING_SMALL, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             SEED + 21))
        host_us = {True: [], False: []}
        for planned in (True, False) + AUTO_HOST_TURNS:
            prev = planner.set_enabled(planned)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(AUTO_HOST_CALLS):
                    mpi.allreduce_rank_major(xs, backend="pallas")
                us = (time.perf_counter() - t0) / AUTO_HOST_CALLS * 1e6
                torch.cuda.synchronize()
            finally:
                planner.set_enabled(prev)
            host_us[planned].append(us)
        host_us = {k: v[1:] for k, v in host_us.items()}  # warm-up turns

        # (f) the TorchMPI-naming surface.
        xs = torch.randn(n, RING_SMALL, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             SEED + 22))
        compat_checks = {"start": compat.start() == dev,
                         "rank_size": (compat.rank(), compat.size()) == (0, 1)}
        compat.collectiveSelector("xla")
        y = compat.allreduceTensor(xs)
        compat_checks["allreduceTensor"] = torch.equal(
            y, closed_form(torch, "allreduce", xs))
        compat_checks["broadcastTensor"] = torch.equal(
            compat.broadcastTensor(xs, root=2),
            closed_form(torch, "broadcast", xs, root=2))
        compat_checks["async_.allreduceTensor"] = torch.equal(
            compat.syncHandle(compat.async_.allreduceTensor(xs)), y)
        compat.set_staged_collectives()
        try:
            compat_checks["staged_equals_direct"] = torch.equal(
                compat.allreduceTensor(xs), y)
        finally:
            compat.set_direct_collectives()
        compat.collectiveSelector("pallas")
        before = dict(ring.LAUNCHES)
        yp = compat.allreduceTensor(xs)
        compat_rows = [k for k, v in ring.LAUNCHES.items() if v != before[k]]
        compat_checks["pallas_bitwise_plain_ring"] = torch.equal(
            yp, ring.ring_allreduce_plain(xs))
        compat.set_hierarchical_collectives()
        hier_on = (mpi.config().hierarchical,
                   mpi.config().backend) == (True, "hierarchical")
        compat.set_flat_collectives()
        compat_checks["hierarchical_then_flat"] = hier_on and (
            mpi.config().hierarchical, mpi.config().backend) == (False,
                                                                 "pallas")
        losses = [float(v) for v in losses]
    finally:
        mpi.stop()
        mpi.init()
        shutil.rmtree(plan_dir, ignore_errors=True)

    med = statistics.median(step_ms)
    emit({"phase": "auto_dp", "ranks": n, "batch_per_rank": b,
          "config": {"model": "ResNet50", "image": R50_IMAGE,
                     "classes": R50_CLASSES, "dtype": "bfloat16",
                     "backend": "auto",
                     "tuning_rounds": tuning.measure.ROUNDS},
          "plan": table, "measured_keys": measured,
          "decision_errors": errors, "first_step_ms": first_ms,
          "plan_rows": plan_rows, "replay_measured": replay_measured,
          "replay_plan_hits": replay_hits, "losses": losses,
          "step_ms": step_ms, "median_step_ms": med,
          "min_step_ms": min(step_ms), "max_step_ms": max(step_ms),
          "img_per_s": n * b * 1e3 / med,
          "turns_step_ms": turns,
          "turns_median_step_ms": {k: statistics.median(v)
                                   for k, v in turns.items()},
          "turns_host_ms": turns_host,
          "turns_median_host_ms": {k: statistics.median(v)
                                   for k, v in turns_host.items()},
          "step_device_profile": profile,
          "reinit_measured": reinit_measured,
          "reinit_bitwise_vs_explicit_backends": reinit_bitwise,
          "grid_key": {"key": grid_dec["key"],
                       "median_ms": grid_entry.median_ms,
                       "jitter_ms": grid_entry.jitter_ms,
                       "winner": grid_entry.backend,
                       "errors": grid_dec.get("errors"),
                       "bitwise_vs_winner": grid_bitwise,
                       "rel_l2_vs_stock": grid_rel,
                       "hops": HIER_HOPS},
          "host_us_per_call": {"planned": host_us[True],
                               "unplanned": host_us[False],
                               "planned_median": statistics.median(
                                   host_us[True]),
                               "unplanned_median": statistics.median(
                                   host_us[False]),
                               "elems": RING_SMALL, "backend": "pallas",
                               "calls_a_turn": AUTO_HOST_CALLS},
          "compat": compat_checks, "compat_pallas_rows": compat_rows,
          "launches": launches, "launches_on_16_byte_path": vector})
    check({t["key"] for t in table} == want_keys and measured ==
          len(want_keys), f"measured {measured} keys {table}, want "
          f"{sorted(want_keys)}")
    check(all("pallas" in t["median_ms"] for t in table) and not errors,
          f"the ring was not measured on every key: {table} {errors}")
    check(replay_measured == 0 and replay_hits > 0,
          f"the replayed steps measured {replay_measured} keys, "
          f"{replay_hits} plan hits")
    check(reinit_measured == 0 and reinit_bitwise,
          f"after re-init: {reinit_measured} measurements, bitwise "
          f"{reinit_bitwise}")
    check(set(grid_entry.median_ms) == {"xla", "pallas", "hierarchical"}
          and not grid_dec.get("errors") and grid_bitwise
          and grid_rel <= BUSBW_STOCK_RTOL,
          f"the dcn 2 x ici 2 key: {grid_dec}, bitwise {grid_bitwise}, "
          f"rel. L2 {grid_rel}")
    check(all(compat_checks.values()) and compat_rows == ["ring_allreduce"],
          f"compat on the card: {compat_checks}, rows {compat_rows}")
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    for name in AUTO_ROWS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              f"auto_dp path")
        check(vector[name]["all"] == vector[name]["vector"],
              f"{name}: {vector[name]} launches on the 16-byte path")
    return launches, dev


def leg_profile(torch, fn, legs=HIER_LEGS) -> dict:
    """Device time of one call of ``fn`` by two-level leg: the kernels
    launched inside each ``record_function`` range of ``legs``
    (torch.profiler, CPU and CUDA activities), and the call's total: the
    device events' own time, so that a kernel is not counted again under
    the host operator that launched it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {leg: {"ms": 0.0, "calls": 0} for leg in legs}
    total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = getattr(e, "cuda_time_total", 0.0) if t is None else t
        if e.key in out:
            out[e.key] = {"ms": t / 1e3, "calls": e.count}
        elif e.device_type == DeviceType.CUDA:
            total += t / 1e3
    return {"legs": out, "step_device_ms": total}


def ef_plain(torch, stacks, residual, n_dcn):
    """The int8 error-feedback sync of rank-major gradient ``stacks`` as
    its plain composition, written out here: each rank's gradients flat,
    each node's ici ranks folded into their shards (rank (d, t) holding
    tile t), the residual added, each shard scaled by its own amax / 127
    (amax times the float32 1/127) and rounded half to even, the decoded
    shards summed over dcn in node
    order.  Returns (synced [L], new residual [n, c], the float32 sum the
    codec quantized, the scales [n_dcn, n_ici], the amaxes)."""
    n = stacks[0].shape[0]
    n_ici = n // n_dcn
    flat = torch.cat([s.reshape(n, -1) for s in stacks], 1)
    L = flat.shape[1]
    c = -(-L // n_ici)
    x = torch.zeros(n, c * n_ici, device=flat.device, dtype=flat.dtype)
    x[:, :L] = flat
    x = x.reshape(n_dcn, n_ici, n_ici, c)
    shards = x[:, 0].clone()
    for i in range(1, n_ici):
        shards += x[:, i]
    y = shards.float() + residual.reshape(n_dcn, n_ici, c)
    amax = y.abs().amax(-1)
    # amax times 1/127 rounded to float32: the JAX package's amax / 127 as
    # XLA compiles it.
    inv = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))
    scale = torch.clamp_min(amax * inv, 1e-30)
    q = torch.clamp(torch.round(y / scale[..., None]), -127.0, 127.0)
    dec = q * scale[..., None]
    tot = dec[0].clone()
    exact = y[0].clone()
    for d in range(1, n_dcn):
        tot = tot + dec[d]
        exact = exact + y[d]
    return (tot.reshape(-1)[:L], (y - dec).reshape(n, c),
            exact.reshape(-1)[:L], scale, amax)


def hier_dp_phase(torch, mpi, ops, dev):
    """This slice's main path: BASELINE config 5, ResNet-50 at full width
    and depth as resnet50_dp runs it (R50_N ranks rank-major, R50_BATCH
    images a rank, SGD), the ranks a HIER_DCN x R50_N / HIER_DCN (dcn x
    ici) grid (Config.dcn_size).

    (a) backend "hierarchical": HIER_CHECKED_STEPS steps in which every
    allreduce (the gradient buckets and the BatchNorm statistics) is held
    bitwise to the same call under dcn_chunk_bytes=0 and within
    HIER_FLAT_RTOL of the flat stock allreduce; HIER_TIMED_STEPS timed by
    CUDA events; one counting host syncs; one profiled by leg.
    (b) HIER_EF_SYNCS synchronize_gradients_rank_major(residuals=...,
    dcn_compress="int8") of one step's gradient stacks, each bitwise to
    the plain composition (ef_plain), the residuals updated, |synced -
    exact| within the codec's bound; the wire bytes.
    (c) backend "pallas" on the grid: HIER_CHECKED_STEPS replicated steps
    and one ZeRO-1 and one ZeRO-3 step, every ring call bitwise to the
    plain ring's composition on the same grid (tap_rank_major_routes).
    (d) the NCCL world of one: backend "hierarchical" warns once and runs
    the stock route.  Every kernel counter is set to 0 just before the
    phase and read just after; both levels are device copies on one card
    (HIER_HOPS)."""
    from torchmpi_tpu_torch.utils import data as dutil
    from torchmpi_tpu_torch.utils.input_pipeline import prefetch_to_device

    ring = ops["ring"]
    recipes, zero, fusion = mpi.recipes, mpi.parallel.zero, mpi.fusion
    hier, gs, sel = (mpi.parallel.hierarchical, mpi.parallel.gradsync,
                     mpi.selector)
    n, b = R50_N, R50_BATCH
    mpi.set_config(dcn_size=HIER_DCN)
    grid = mpi.runtime.grid(n)
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    model = mpi.models.ResNet50(num_classes=R50_CLASSES,
                                dtype=torch.bfloat16, device=dev,
                                generator=g)
    params, stats = recipes.bn_state(model)
    spec = fusion.FusedSpec(params)
    tx = mpi.optim.sgd(R50_LR, momentum=R50_MOMENTUM)
    opt = [tx.init(p) for p in params]
    step = recipes.make_bn_dp_train_step_rank_major(
        model, tx, n, backend="hierarchical")
    X, Y = dutil.synthetic_image_classification(
        2 * n * b, image_shape=(R50_IMAGE, R50_IMAGE, 3),
        num_classes=R50_CLASSES, seed=SEED + 1)
    n_batches = 2 * HIER_CHECKED_STEPS + HIER_TIMED_STEPS + 6
    it = prefetch_to_device(dutil.batches(X, Y, n * b, steps=n_batches,
                                          seed=SEED + 1), depth=2,
                            device=dev)

    def batch():
        xb, yb = next(it)
        return xb.permute(0, 3, 1, 2), yb

    def one_step(st, xb, yb):
        nonlocal params, opt, stats
        params, opt, stats, loss = st(params, opt, stats, xb, yb)
        return loss

    torch.cuda.synchronize()
    for mod in ops.values():
        mod.reset_launches()
    # (a) the hierarchical route, tapped during the checked steps.
    route = hier.hier_allreduce_rank_major
    log = []

    def tapped(xs, op="sum", *, n_dcn):
        out = route(xs, op=op, n_dcn=n_dcn)
        mpi.set_config(dcn_chunk_bytes=0)
        try:
            whole = route(xs, op=op, n_dcn=n_dcn)
        finally:
            mpi.set_config(dcn_chunk_bytes=4 << 20)
        flat = mpi.collectives._stock_allreduce_rank_major(xs, op=op)
        diff = (out.float() - flat.float()).norm()
        log.append({"elems": xs[0].numel(), "chunks": hier.chunk_count(
            xs[0].numel(), xs.element_size(), grid[1]),
            "bitwise_vs_unchunked": bool(torch.equal(out, whole)),
            "rel_l2_vs_flat": float(diff / flat.float().norm().clamp_min(
                1e-30))})
        return out

    sel.register("allreduce_rank_major", "hierarchical", tapped)
    losses = []
    try:
        for _ in range(HIER_CHECKED_STEPS):
            losses.append(one_step(step, *batch()))
    finally:
        sel.register("allreduce_rank_major", "hierarchical", route)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(HIER_TIMED_STEPS):
        xb, yb = batch()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(one_step(step, xb, yb))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    xb, yb = batch()
    syncs = count_host_syncs(torch, lambda: losses.append(
        one_step(step, xb, yb)))
    xb, yb = batch()
    legs = leg_profile(torch, lambda: losses.append(one_step(step, xb, yb)))

    # (b) int8 error feedback on one step's gradient stacks.
    local = recipes._local_step(recipes._loss_of(model, False))
    xb, yb = batch()
    xs, ys = xb.reshape(n, -1, *xb.shape[1:]), yb.reshape(n, -1)
    stacks = [p.new_empty((n, *p.shape)) for p in params]
    for r in range(n):
        _, grads, _ = local(params, stats, xs[r], ys[r])
        for st, gr in zip(stacks, grads):
            st[r].copy_(gr)
        del grads
    res = gs.init_dcn_residuals(params, n=n)
    ef = []
    for _ in range(HIER_EF_SYNCS):
        synced = [st.clone() for st in stacks]
        want, want_res, exact, scale, amax = ef_plain(torch, stacks, res[0],
                                                      grid[0])
        _, new_res = gs.synchronize_gradients_rank_major(
            synced, op="sum", residuals=res, dcn_compress="int8")
        got = torch.cat([t.reshape(n, -1) for t in synced], 1)
        ulp = lambda t: torch.abs(torch.nextafter(  # noqa: E731
            t.abs(), torch.full_like(t, float("inf"))) - t.abs())
        def per_element(per_tile):
            return per_tile[:, None].expand(grid[1], res[0].shape[1]) \
                .reshape(-1)[:exact.numel()]

        bound = (per_element((scale / 2 + amax * 2.0 ** -23).sum(0))
                 + ulp(want) + ulp(exact))
        # Without the roundings of y / scale and of the decode products.
        half = per_element((scale / 2).sum(0)) + ulp(exact)
        err = (want - exact).abs()
        ef.append({
            "bitwise_vs_plain": bool(all(torch.equal(got[r], want)
                                         for r in range(n))),
            "residual_bitwise": bool(torch.equal(new_res[0], want_res)),
            "residual_changed": bool(not torch.equal(new_res[0], res[0])),
            "max_abs_err": float(err.max()),
            "max_err_over_bound": float((err / bound).max()),
            "max_err_over_half_scales_and_ulp": float((err / half).max()),
            "within_bound": bool((err <= bound).all())})
        res = new_res
    from torchmpi_tpu_torch import compress as codec

    shard = res[0].shape[1]
    wire = {"shard_elems_per_rank": shard,
            "int8_bytes_per_rank": codec.wire_nbytes_of(shard, "int8"),
            "float32_bytes_per_rank": shard * 4}
    del stacks, synced, got

    # (c) the ring kernels on the grid: replicated, ZeRO-1, ZeRO-3.
    step_p = recipes.make_bn_dp_train_step_rank_major(model, tx, n,
                                                      backend="pallas")
    rlog = TapLog()
    restore = tap_rank_major_routes(torch, mpi, ring, rlog, ops=(
        "reduce_scatter_rank_major", "allgather_rank_major",
        "allreduce_rank_major"))
    zspec = zero.flat_spec(params, n_shards=n)
    template = [torch.empty_like(p, device="meta") for p in params]
    torch.backends.cudnn.deterministic = True
    try:
        rlog.label = "replicated"
        for _ in range(HIER_CHECKED_STEPS):
            losses.append(one_step(step_p, *batch()))
        zstate = mpi.optim.TraceState(
            fusion.local_shards([s.trace for s in opt], zspec))
        xb, yb = batch()
        rlog.label = "zero1"
        step1 = recipes.make_bn_dp_train_step_rank_major(
            model, tx, n, backend="pallas", zero=1)
        p_z1, _, _, l_z1 = step1(params, zstate, stats, xb, yb)
        rlog.label = "zero3"
        step3 = recipes.make_bn_dp_train_step_rank_major(
            model, tx, n, backend="pallas", zero=3,
            params_template=template)
        p_z3, _, _, l_z3 = step3(zero.shard_params_rank_major(params, n),
                                 zstate, stats, xb, yb)
    finally:
        torch.backends.cudnn.deterministic = False
        restore()
    losses += [l_z1, l_z3]
    z3_eq_z1 = bool(torch.equal(fusion.local_shards(p_z1, zspec), p_z3))
    launches = {k: ring.LAUNCHES[k] for k in HIER_ROWS}
    vector = {k: {"all": ring.LAUNCHES[k],
                  "vector": ring.VECTOR_LAUNCHES[k]} for k in HIER_ROWS}
    rows_by_label = {}
    for e in rlog:
        for row in e["rows"]:
            d = rows_by_label.setdefault(f"{e['label']} {row}",
                                         {"calls": 0, "bitwise": True})
            d["calls"] += 1
            d["bitwise"] = d["bitwise"] and e["bitwise"]

    # (d) the NCCL world of one.
    sel._warned_fallbacks.discard(("allreduce", "hierarchical"))
    x = torch.randn(1 << 20, generator=g, device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        one = [mpi.allreduce(x, backend="hierarchical") for _ in range(2)]
    warned = [str(w.message) for w in caught
              if issubclass(w.category, RuntimeWarning)
              and "hierarchical" in str(w.message)]
    fallback_ok = all(torch.equal(o, mpi.allreduce(x)) for o in one)
    mpi.set_config(dcn_size=None)

    losses = [float(v) for v in losses]
    med = statistics.median(step_ms)
    emit({"phase": "hier_dp", "ranks": n, "grid": {"dcn": grid[0],
                                                   "ici": grid[1]},
          "batch_per_rank": b, "hops": HIER_HOPS,
          "config": {"model": "ResNet50", "image": R50_IMAGE,
                     "classes": R50_CLASSES, "dtype": "bfloat16",
                     "params": "float32", "optimizer":
                     f"sgd({R50_LR}, momentum={R50_MOMENTUM})",
                     "backend": "hierarchical", "dcn_chunk_bytes": 4 << 20,
                     "memory_format": "channels_last"},
          "buckets": spec.n_launches, "losses": losses,
          "hier_syncs": log,
          "step_ms": step_ms, "median_step_ms": med,
          "min_step_ms": min(step_ms), "max_step_ms": max(step_ms),
          "img_per_s": n * b * 1e3 / med, "peak_mem_bytes": peak,
          "host_syncs_per_step": syncs, "leg_profile": legs,
          "ef_int8": ef, "ef_wire": wire,
          "pallas_rows": rows_by_label,
          "pallas_bitwise_vs_plain": all(e["bitwise"] for e in rlog),
          "pallas_collectives_checked": len(rlog),
          "zero3_equals_zero1": z3_eq_z1,
          "launches": launches, "launches_on_16_byte_path": vector,
          "world_of_one_warnings": warned,
          "world_of_one_stock_result": fallback_ok})
    check(len(log) == HIER_CHECKED_STEPS * (R50_BUCKETS + 1),
          f"{len(log)} hierarchical syncs checked")
    check(all(e["bitwise_vs_unchunked"] for e in log),
          f"a chunked hierarchical sync differs from the unchunked: {log}")
    check(all(e["rel_l2_vs_flat"] <= HIER_FLAT_RTOL for e in log),
          f"hierarchical vs flat: {log}")
    check(max(e["chunks"] for e in log) == HIER_CHUNKS,
          f"the gradient buckets ran in {[e['chunks'] for e in log]} chunks")
    check(all(e["bitwise_vs_plain"] and e["residual_bitwise"]
              and e["residual_changed"] and e["within_bound"] for e in ef),
          f"int8 error feedback: {ef}")
    check(all(e["bitwise"] for e in rlog) and len(rlog) > 0,
          f"a ring call on the grid differs from the plain ring: "
          f"{rows_by_label}")
    check(z3_eq_z1, "ZeRO-3 differs from ZeRO-1 on the grid")
    for name in HIER_ROWS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              f"two-level path")
    for name in R50_VECTOR_ROWS:
        check(vector[name]["all"] == vector[name]["vector"],
              f"{name}: {vector[name]} launches on the 16-byte path")
    check(len(warned) == 1 and fallback_ok,
          f"world of one: {warned}, stock result {fallback_ok}")
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    check(syncs == 0, f"{syncs} host-device synchronizations in a step")
    return launches


def closed_form(torch, verb, xs, root=0, op="sum", src=0, dst=1):
    """Rank-major ``verb`` of ``xs`` [n, ...] as the JAX package's host
    closed forms define it (``_host_staged``), in plain torch: sums as a
    left fold over the ranks in the stack's dtype, a mean as the sum over
    n (float32 for integers), non-root slices unchanged by reduce and
    zeros for gather, alltoall tiled along the leading dim."""
    n = xs.shape[0]

    def reduced():
        acc = xs[0].clone()
        for r in range(1, n):
            acc = acc + xs[r]
        return acc / n if op == "mean" else acc

    if verb == "allreduce":
        red = reduced()
        return torch.stack([red] * n)
    if verb == "broadcast":
        return torch.stack([xs[root]] * n)
    if verb == "reduce":
        red = reduced()
        return torch.stack([red if r == root else xs[r].to(red.dtype)
                            for r in range(n)])
    if verb == "allgather":
        return torch.stack([xs] * n)
    if verb == "reduce_scatter":
        return reduced().reshape(n, -1)
    if verb == "gather":
        return torch.stack([xs if r == root else torch.zeros_like(xs)
                            for r in range(n)])
    if verb == "scatter":
        return xs[root].reshape(n, -1).clone()
    if verb == "sendreceive":
        return torch.stack([xs[src] if r == dst else xs[r]
                            for r in range(n)])
    if verb == "alltoall":
        pieces = xs.reshape(n, n, -1)
        return torch.stack([pieces[:, i].reshape(-1) for i in range(n)])
    raise ValueError(verb)


def async_verbs_phase(torch, mpi, ring, dev):
    """The async slice's verbs: ASYNC_N ranks rank-major on the card, the
    nine verbs at each dtype of ASYNC_SIZES against their closed forms
    computed on the CPU (bitwise), staged equal to direct (bitwise, dtype
    included), every async handle (direct on the side stream and staged)
    equal to its synchronous call; ``async_.allreduce`` under "pallas"
    bitwise equal to the synchronous ring call and launched on the side
    stream; ``donate=True`` releasing the input's bytes before ``wait()``;
    ``wait_all``'s order and a failed handle (an indivisible scatter) done
    and raising on each wait; then the nine process-world verbs and their
    ``async_in_axis`` forms over NCCL in the world of one."""
    coll = mpi.collectives
    n = ASYNC_N
    g = torch.Generator().manual_seed(SEED + 9)
    results, dtypes = {}, {}
    t0 = time.perf_counter()
    for name, size in ASYNC_SIZES.items():
        dtype = getattr(torch, name)
        for verb, params in ASYNC_PARAMS.items():
            L = -(-size // n) * n if verb in ASYNC_TILED else size
            if dtype == torch.int32:
                host = torch.randint(-1000, 1000, (n, L), generator=g,
                                     dtype=torch.int32)
            else:
                host = torch.randn(n, L, generator=g).to(dtype)
            xs = host.to(dev)
            want = closed_form(torch, verb, host, **params)
            fn = getattr(mpi, f"{verb}_rank_major")
            direct = fn(xs, **params)
            staged = fn(xs, staged=True, **params)
            h_direct = getattr(mpi.async_, verb)(xs, **params)
            h_staged = getattr(mpi.async_, verb)(xs, staged=True, **params)
            outs = mpi.wait_all([h_direct, h_staged])
            key = f"{verb}_{name}"
            results[key] = {
                "closed_form": torch.equal(direct.cpu(), want),
                "staged": (staged.dtype == direct.dtype
                           and torch.equal(staged, direct)),
                "async_direct": torch.equal(outs[0], direct),
                "async_staged": torch.equal(outs[1], direct),
                "elems": L}
            dtypes[key] = str(direct.dtype)
            del xs, direct, staged, outs, h_direct, h_staged
    verbs_s = time.perf_counter() - t0

    # async_.allreduce on the ring: on the side stream, bitwise as sync.
    xs = torch.randn(n, RING_BUCKET, generator=g).to(dev)
    route = mpi.selector.available("allreduce_rank_major")["pallas"]
    streams = []

    def spy(x, **kw):
        streams.append(torch.cuda.current_stream().cuda_stream)
        return route(x, **kw)

    mpi.selector.register("allreduce_rank_major", "pallas", spy)
    before = dict(ring.LAUNCHES)
    try:
        h = mpi.async_.allreduce(xs, backend="pallas")
        a = h.wait()
    finally:
        mpi.selector.register("allreduce_rank_major", "pallas", route)
    ring_rows = [k for k, v in ring.LAUNCHES.items() if v != before[k]]
    b = mpi.allreduce_rank_major(xs, backend="pallas")
    caller = torch.cuda.current_stream().cuda_stream
    side = coll.side_stream(dev).cuda_stream
    ms_sync = time_ms(torch, lambda: mpi.allreduce_rank_major(
        xs, backend="pallas"), iters=5)
    ms_async = time_ms(torch, lambda: mpi.async_.allreduce(
        xs, backend="pallas").wait(), iters=5)
    ms_staged = time_ms(torch, lambda: mpi.async_.allreduce(
        xs, staged=True).wait(), iters=3, warmup=1)
    ring_ok = {"bitwise": torch.equal(a, b), "streams": streams,
               "caller": caller, "side": side, "rows": ring_rows}

    # donate: the input's bytes leave the card once staged, before wait().
    x = torch.randn(n, RING_BUCKET, generator=g).to(dev)
    ref = mpi.allreduce_rank_major(x)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    h = mpi.async_.allreduce(x, staged=True, donate=True)
    t1 = time.monotonic()
    while not h.done and time.monotonic() - t1 < 120:
        time.sleep(0.001)
    dropped = mem0 - torch.cuda.memory_allocated()
    donated = {"input_bytes": x.numel() * x.element_size(),
               "dropped_before_wait": dropped, "done": h.done,
               "equal": torch.equal(h.wait(), ref),
               "storage_left": x.untyped_storage().size()}
    del x, ref

    # wait_all order and a failed handle.
    ys = [torch.full((n, 1000), float(i), device=dev) for i in range(5)]
    hs = [mpi.async_.allreduce(y, staged=i % 2 == 1)
          for i, y in enumerate(ys)]
    order = all(torch.equal(o, closed_form(torch, "allreduce", y.cpu())
                            .to(dev))
                for o, y in zip(mpi.wait_all(hs), ys))
    bad = mpi.async_.scatter(torch.ones(n, 7, device=dev))
    errors = []
    for _ in range(2):
        try:
            bad.wait()
        except ValueError as e:
            errors.append(str(e))
    failed = {"done": bad.done, "raised_each_wait": len(errors) == 2}

    # The process world of one over NCCL: every verb and its async form.
    x1 = torch.randn(RING_SMALL - 1, generator=g).to(dev)
    world = {}
    for verb in coll.VERBS:
        params = ({"src": 0, "dst": 0} if verb == "sendreceive" else
                  {"op": "mean"} if verb == "reduce" else {})
        want = closed_form(torch, verb, x1.cpu()[None], **params)[0]
        got = getattr(mpi, verb)(x1, **params)
        h = getattr(mpi.async_in_axis, verb)(x1, **params)
        world[verb] = {"sync": torch.equal(got.cpu(), want),
                       "async": torch.equal(h.wait(), got),
                       "done": h.done}
    emit({"phase": "async_verbs", "ranks": n,
          "sizes": {k: v for k, v in ASYNC_SIZES.items()},
          "verbs": results, "dtypes": dtypes, "verbs_seconds": verbs_s,
          "ring_async": ring_ok, "allreduce_pallas_ms": ms_sync,
          "async_allreduce_pallas_ms": ms_async,
          "async_staged_allreduce_xla_ms": ms_staged, "donate": donated,
          "wait_all_in_order": order, "failed_handle": failed,
          "world_of_one": world})
    for key, r in results.items():
        check(all(r[k] for k in ("closed_form", "staged", "async_direct",
                                 "async_staged")), f"{key}: {r}")
    check(ring_ok["bitwise"] and streams and all(
        st == side != caller for st in streams) and ring_rows,
          f"async ring allreduce: {ring_ok}")
    check(donated["done"] and donated["equal"]
          and donated["storage_left"] == 0
          and donated["input_bytes"] <= dropped
          < donated["input_bytes"] + (2 << 20),
          f"donate: {donated}")
    check(order and failed["done"] and failed["raised_each_wait"],
          f"wait_all order {order}, failed handle {failed}")
    check(all(all(v.values()) for v in world.values()),
          f"process-world verbs: {world}")


def stream_profile(torch, fn) -> dict:
    """Device time of one call of ``fn`` by CUDA stream, from
    torch.profiler's trace: each stream's kernel and copy time and busy
    span, and how much of the other streams' busy time fell while the
    busiest stream (the compute stream) was busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "overlap_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    spans = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and \
                "dur" in e:
            st = (e.get("args") or {}).get("stream")
            spans.setdefault(st, []).append((e["ts"], e["ts"] + e["dur"]))

    def merged(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def length(iv):
        return sum(b - a for a, b in iv)

    def overlap(p, q):
        i = j = 0
        tot = 0.0
        while i < len(p) and j < len(q):
            lo, hi = max(p[i][0], q[j][0]), min(p[i][1], q[j][1])
            tot += max(0.0, hi - lo)
            if p[i][1] < q[j][1]:
                i += 1
            else:
                j += 1
        return tot

    busy = {st: merged(iv) for st, iv in spans.items()}
    if not busy:
        return {"streams": {}}
    main = max(busy, key=lambda st: length(busy[st]))
    return {"main_stream": main, "streams": {
        str(st): {"ops": len(spans[st]),
                  "device_ms": sum(b - a for a, b in spans[st]) / 1e3,
                  "busy_ms": length(busy[st]) / 1e3,
                  "concurrent_with_main_ms": (
                      None if st == main else
                      overlap(busy[st], busy[main]) / 1e3)}
        for st in busy}}


def overlap_dp_phase(torch, mpi, ops, dev):
    """The overlap slice's main path: ResNet-50 as resnet50_dp runs it
    (R50_N ranks rank-major, R50_BATCH images a rank, 224 x 224, bf16,
    SGD, backend "pallas", prefetch_to_device), with overlap="auto": the
    last rank's backward fires each reverse-parameter-order bucket's ring
    allreduce from the tensor hooks on the side stream.  Three steps with
    every bucket (rows 8 / 11) and the statistics (row 11) held bitwise to
    the plain ring on the same input, the buckets on the side stream and
    the statistics on the caller's; one overlapped gradient computation
    whose synced gradients are bitwise the plain ring on the overlap
    layout and within OV_FUSED_RTOL (rel. L2 per tensor) of the
    non-overlapped 32 MiB sync of the same stacks; steps timed by CUDA
    events in turns with non-overlapped ones; one counting host syncs
    (0); one of each profiled by stream; a ZeRO-1 presynced step within
    R50_ZERO_RTOL of a replicated one (row 10 bitwise); a replicated step
    with n_buckets=4 and no overlap, every bucket bitwise the plain ring.
    Every launch of rows 8 and 11 on the 16-byte path.  The counters are
    set to 0 just before and read just after; the launches of the
    non-overlapped steps and comparisons are taken out."""
    from torchmpi_tpu_torch.utils import data as dutil
    from torchmpi_tpu_torch.utils.input_pipeline import prefetch_to_device

    ring = ops["ring"]
    recipes, zero, fusion = mpi.recipes, mpi.parallel.zero, mpi.fusion
    gs, sel = mpi.parallel.gradsync, mpi.selector
    n, b = R50_N, R50_BATCH
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    model = mpi.models.ResNet50(num_classes=R50_CLASSES,
                                dtype=torch.bfloat16, device=dev,
                                generator=g)
    params, stats = recipes.bn_state(model)
    tx = mpi.optim.sgd(R50_LR, momentum=R50_MOMENTUM)
    opt = [tx.init(p) for p in params]
    bound = gs.overlap_bucket_bytes()
    firing = gs.assign_overlap_buckets(params, bound)
    bucket_elems = [sum(params[i].numel() for i in bk) for bk in firing]
    chunk_bytes = mpi.effective_config().chunk_bytes
    bucket_rows = [ring.schedule(m, n, torch.float32,
                                 chunk_bytes=chunk_bytes,
                                 bidirectional=False)[0]
                   for m in bucket_elems]
    step_ov = recipes.make_bn_dp_train_step_rank_major(
        model, tx, n, backend="pallas", overlap="auto")
    step_plain = recipes.make_bn_dp_train_step_rank_major(
        model, tx, n, backend="pallas")
    X, Y = dutil.synthetic_image_classification(
        2 * n * b, image_shape=(R50_IMAGE, R50_IMAGE, 3),
        num_classes=R50_CLASSES, seed=SEED + 1)
    n_batches = 3 + 1 + 2 * R50_TIMED_STEPS + 1 + 2 + 1 + 1
    it = prefetch_to_device(dutil.batches(X, Y, n * b, steps=n_batches,
                                          seed=SEED + 1), depth=2,
                            device=dev)

    def batch():
        xb, yb = next(it)
        return xb.permute(0, 3, 1, 2), yb

    def run(step, xb, yb):
        nonlocal params, opt, stats
        params, opt, stats, loss = step(params, opt, stats, xb, yb)
        return loss

    def counts():
        return {k: ring.LAUNCHES[k] for k in ring.KERNELS}

    excluded = {k: 0 for k in ring.KERNELS}

    def not_counted(fn):
        before = counts()
        out = fn()
        for k, v in counts().items():
            excluded[k] += v - before[k]
        return out

    side = mpi.collectives.side_stream(dev).cuda_stream
    caller = torch.cuda.current_stream().cuda_stream
    log, losses = TapLog(), []
    torch.cuda.synchronize()
    for mod in ops.values():
        mod.reset_launches()
    restore = tap_rank_major_routes(torch, mpi, ring, log,
                                    ops=("allreduce_rank_major",))
    try:
        log.label = "overlap"
        for _ in range(3):
            losses.append(run(step_ov, *batch()))
    finally:
        restore()

    # One overlapped gradient computation, its buckets' inputs kept: the
    # synced stacks against the plain ring on the overlap layout (bitwise)
    # and against the non-overlapped fused sync of the same stacks.
    loss_of = recipes._loss_of(model, False)
    route = sel.available("allreduce_rank_major")["pallas"]
    kept = []

    def keep(xs, **kw):
        kept.append(xs.clone())
        return route(xs, **kw)

    xb, yb = batch()
    vag = gs.make_overlapped_grad_fn_rank_major(
        lambda leaves, x, y: loss_of(leaves, stats, x, y), params, n,
        backend="pallas", has_aux=True)
    sel.register("allreduce_rank_major", "pallas", keep)
    try:
        _, synced = vag(params, xb, yb)
    finally:
        sel.register("allreduce_rank_major", "pallas", route)
    raw = [p.new_zeros((n, *p.shape)) for p in params]
    for bk, buf in zip(firing, kept):
        fusion.scatter_bucket(buf, raw, fusion.bucket_group(params, bk), 0,
                              rank_major=True)
    plain_ov = [t.clone() for t in raw]
    for bk in firing:
        grp = fusion.bucket_group(params, bk)
        buf = fusion.gather_bucket(plain_ov, grp, 0, grp.total,
                                   rank_major=True)
        fusion.scatter_bucket(ring.ring_allreduce_plain(buf, op="mean"),
                              plain_ov, grp, 0, rank_major=True)
    fused = [t.clone() for t in raw]
    not_counted(lambda: gs.synchronize_gradients_rank_major(
        fused, backend="pallas"))
    with torch.no_grad():
        ov_bitwise = all(torch.equal(a, c) for a, c in zip(synced, plain_ov))
        rel = [float((a - c).float().norm()
                     / c.float().norm().clamp_min(1e-30))
               for a, c in zip(synced, fused)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    del kept, raw, plain_ov, fused, synced

    # Timed steps, overlapped and not, in turns.
    step_ms = {"overlap": [], "plain": []}
    peak = {"overlap": 0, "plain": 0}
    for i in range(R50_TIMED_STEPS):
        order = ("overlap", "plain") if i % 2 == 0 else ("plain", "overlap")
        for label in order:
            xb, yb = batch()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)

            def timed():
                start.record()
                losses.append(run(step_ov if label == "overlap"
                                  else step_plain, xb, yb))
                end.record()
                end.synchronize()
            if label == "overlap":
                timed()
            else:
                not_counted(timed)
            step_ms[label].append(start.elapsed_time(end))
            peak[label] = max(peak[label], torch.cuda.max_memory_allocated())
    xb, yb = batch()
    syncs = count_host_syncs(torch, lambda: losses.append(
        run(step_ov, xb, yb)))
    xb, yb = batch()
    prof_ov = stream_profile(torch, lambda: losses.append(
        run(step_ov, xb, yb)))
    xb, yb = batch()
    prof_plain = not_counted(lambda: stream_profile(
        torch, lambda: losses.append(run(step_plain, xb, yb))))
    launches_ov = {k: v - excluded[k] for k, v in counts().items()}
    vector = {k: {"all": ring.LAUNCHES[k], "vector": ring.VECTOR_LAUNCHES[k]}
              for k in OV_VECTOR_ROWS}

    # ZeRO-1 presynced from the replicated state, beside a replicated step
    # on the same batch (cuDNN's deterministic algorithms for both); then a
    # replicated step with 4 buckets and no overlap.
    zspec = zero.flat_spec(params, n_shards=n)
    zstate = mpi.optim.TraceState(
        fusion.local_shards([s.trace for s in opt], zspec))
    step1 = recipes.make_bn_dp_train_step_rank_major(
        model, tx, n, backend="pallas", zero=1, overlap="auto")
    step_b4 = recipes.make_bn_dp_train_step_rank_major(
        model, tx, n, backend="pallas", n_buckets=4)
    xb, yb = batch()
    restore = tap_rank_major_routes(torch, mpi, ring, log, ops=(
        "allgather_rank_major", "allreduce_rank_major"))
    torch.backends.cudnn.deterministic = True
    try:
        log.label = "replicated"
        p_rep, _, _, l_rep = not_counted(
            lambda: step_plain(params, opt, stats, xb, yb))
        log.label = "zero1_presynced"
        before = counts()
        p_z1, _, _, l_z1 = step1(params, zstate, stats, xb, yb)
        z1_launches = {k: v - before[k] for k, v in counts().items()}
        log.label = "buckets4"
        xb, yb = batch()
        _, _, _, l_b4 = not_counted(
            lambda: step_b4(params, opt, stats, xb, yb))
    finally:
        torch.backends.cudnn.deterministic = False
        restore()
    launches = {k: launches_ov[k] + z1_launches[k] for k in OV_ROWS}
    losses += [l_rep, l_z1, l_b4]
    with torch.no_grad():
        zrel = [float(((a - p) - (r - p)).norm()
                      / (r - p).norm().clamp_min(1e-30))
                for a, r, p in zip(p_z1, p_rep, params)]
    zworst = max(range(len(zrel)), key=zrel.__getitem__)
    losses = [float(v) for v in losses]
    by_label = {}
    for e in log:
        d = by_label.setdefault(e["label"], {
            "calls": 0, "bitwise": True, "rows": set(), "streams": set(),
            "elems": []})
        d["calls"] += 1
        d["bitwise"] = d["bitwise"] and e["bitwise"]
        d["rows"].update(e["rows"])
        d["streams"].add("side" if e["stream"] == side else
                         "caller" if e["stream"] == caller else "other")
        d["elems"].append(e["elems"])
    by_label = {k: dict(v, rows=sorted(v["rows"]),
                        streams=sorted(v["streams"]))
                for k, v in by_label.items()}
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    emit({"phase": "overlap_dp", "ranks": n, "batch_per_rank": b,
          "config": {"model": "ResNet50", "image": R50_IMAGE,
                     "classes": R50_CLASSES, "dtype": "bfloat16",
                     "params": "float32", "optimizer":
                     f"sgd({R50_LR}, momentum={R50_MOMENTUM})",
                     "backend": "pallas", "overlap": "auto"},
          "overlap_bucket_bytes": bound, "buckets": len(firing),
          "bucket_elems": bucket_elems, "bucket_rows": bucket_rows,
          "losses": losses, "step_ms": step_ms, "median_step_ms": med,
          "img_per_s": {k: n * b * 1e3 / v for k, v in med.items()},
          "peak_mem_bytes": peak, "host_syncs_per_step": syncs,
          "stream_profile": {"overlap": prof_ov, "plain": prof_plain},
          "syncs_by_label": by_label,
          "overlap_layout_bitwise_vs_plain_ring": ov_bitwise,
          "vs_fused_sync_max_rel_l2": rel[worst],
          "vs_fused_sync_worst_tensor": [nm for nm, _ in
                                         model.named_parameters()][worst],
          "vs_fused_sync_tolerance": OV_FUSED_RTOL,
          "zero1_presynced_vs_replicated_max_rel_l2": zrel[zworst],
          "zero1_tolerance": R50_ZERO_RTOL,
          "launches": launches, "launches_on_16_byte_path": vector,
          "side_stream": side, "caller_stream": caller})
    ov = by_label["overlap"]
    check(all(e["bitwise"] and e.get("rows_equal", True) for e in log),
          f"an overlap_dp sync differs from the plain ring: {by_label}")
    grad_entries = [e for e in log if e["label"] == "overlap"
                    and e["elems"] != R50_STATS]
    check([e["elems"] for e in grad_entries] == bucket_elems * 3
          and all(e["stream"] == side != caller for e in grad_entries)
          and all(e["stream"] == caller for e in log
                  if e["label"] == "overlap" and e["elems"] == R50_STATS)
          and ov["calls"] == 3 * (len(firing) + 1),
          f"overlap buckets {bucket_elems}: {ov}")
    check({r for e in grad_entries for r in e["rows"]}
          == set(bucket_rows), f"bucket rows {bucket_rows}: {ov}")
    check(ov_bitwise, "overlapped gradients differ from the plain ring on "
          "the overlap layout")
    check(rel[worst] <= OV_FUSED_RTOL,
          f"overlap vs the fused sync: {rel[worst]} ({worst})")
    check(by_label["buckets4"]["calls"] == 5,
          f"n_buckets=4: {by_label['buckets4']}")
    check(zrel[zworst] <= R50_ZERO_RTOL,
          f"ZeRO-1 presynced vs replicated: {zrel[zworst]} ({zworst})")
    check(syncs == 0, f"{syncs} host-device synchronizations in a step")
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    for name in OV_ROWS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              f"overlap path")
    for name in OV_VECTOR_ROWS:
        check(vector[name]["all"] == vector[name]["vector"],
              f"{name}: {vector[name]} launches on the 16-byte path")
    return launches


def cnn_examples_phase(torch, mpi):
    """The port's main-path examples (CIFAR also under ZeRO-3, the async
    example bucketed and overlapped; the parameter-server and checkpoint
    examples) run in-process on the card, each to its bar."""
    import importlib

    runs = []
    ps_runs = [(name, argv, bar, {}) for name, argv, bar in PS_EXAMPLES]
    for name, argv, bar, knobs in CNN_EXAMPLES + tuple(ps_runs):
        mod = importlib.import_module(f"torchmpi_tpu_torch.examples.{name}")
        t0 = time.perf_counter()
        before = {k: getattr(mpi.config(), k) for k in knobs}
        mpi.set_config(**knobs)
        try:
            out = mod.main(["--device", "cuda", *argv])
        finally:
            mpi.set_config(**before)
        check(out.get("overlap", False) == bool(knobs),
              f"{name}: overlap {out.get('overlap')} under {knobs}")
        runs.append({"example": name, "argv": list(argv), "bar": bar,
                     "config": knobs, "accuracy": out.get("accuracy"),
                     "img_per_s": out.get("img_per_s"),
                     "losses": out["losses"],
                     **({"ops_served": out["ops_served"]}
                        if "ops_served" in out else {}),
                     **({"pre_crash": out["pre_crash"], "final":
                         out["final"], "resume_step": out["resume_step"]}
                        if "final" in out else {}),
                     "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    emit({"phase": "cnn_examples", "runs": runs})
    for r in runs:
        if r["bar"] is None:  # checkpoint_resume: final below pre-crash
            check(r["final"] < r["pre_crash"], f"{r['example']}: final "
                  f"loss {r['final']} >= {r['pre_crash']} at the crash")
        else:
            check(r["accuracy"] > r["bar"], f"{r['example']} {r['argv']}: "
                  f"accuracy {r['accuracy']} <= {r['bar']}")


def fsdp_dp_phase(torch, mpi, ops, dev):
    """The FSDP slice's main path: the flagship as FSDP of RING_N ranks on
    one card (recipes.make_fsdp_train_step_rank_major, backend "pallas",
    Adam lr 1e-3, the fused loss), rank r taking sequence r of the batch of
    4.  One untimed warm-up step and one under the resident chunk_bytes are
    checked: every all-gather and every reduce-scatter bucket against the
    plain ring on the same input (tap_rank_major_routes), every fused
    reduce-scatter against the per-leaf one of the same stacks, and the
    warm-up's update against a replicated step from the same parameters,
    state and gradient stacks (the fused ring allreduce mean, Adam on the
    full tensors).  FSDP_TIMED_STEPS between them are timed by CUDA
    events, the gathers and reduce-scatters by the tap's events.  Then one
    step's peak memory, one counting the host syncs, one profiled by part.
    Then the process-world form at world one (NCCL) against the rank-major
    form at n = 1 from the same parameters and batch.  Every kernel
    counter is set to 0 just before the main path and read just after; the
    checks' own ring launches are taken out."""
    ring = ops["ring"]
    recipes, fusion = mpi.recipes, mpi.fusion
    n = RING_N
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    model = mpi.models.TransformerLM(**LM, attn_impl="flash",
                                     dtype=torch.bfloat16, device=dev,
                                     generator=g)
    tok = torch.randint(0, LM["vocab"], (BATCH, SEQ), generator=g,
                        device=dev)
    full = [p.detach() for p in model.parameters()]
    names = [nm for nm, _ in model.named_parameters()]
    tx = mpi.optim.adam(ZERO_LR)

    def loss_fn(apply_fn, params, xb, yb):
        """fused_lm_loss on the gathered parameters: xb = yb = tokens."""
        h, head = apply_fn(params, xb, return_prehead=True)
        E = h.shape[-1]
        return mpi.ops.fused_linear_cross_entropy(
            h[:, :-1].reshape(-1, E).to(torch.bfloat16),
            head.to(torch.bfloat16), yb[:, 1:].reshape(-1)).mean()

    step, params, state = recipes.make_fsdp_train_step_rank_major(
        model, tx, full, n, backend="pallas", loss_fn=loss_fn)
    dims = step.dims
    full_bytes = sum(p.numel() * p.element_size() for p in full)

    def rank_bytes():
        return sum(t.numel() * t.element_size() // (n if d is not None
                                                      else 1)
                   for d, p, s in zip(dims, params, state)
                   for t in (p, s.mu, s.nu))

    persistent = rank_bytes() / (3 * full_bytes)
    sharded = [i for i, d in enumerate(dims) if d is not None]
    fuse0 = mpi.config().fuse_max_bytes

    log = TapLog()
    excluded = dict.fromkeys(ring.KERNELS, 0)
    captured, fused_eq = {}, []

    def exclude(before):
        for k in ring.KERNELS:
            excluded[k] += ring.LAUNCHES[k] - before[k]

    plain_rs = fusion.fused_reduce_scatter_rank_major

    def checked_rs(stacks, **kw):
        """The step's fused reduce-scatter; in a checked step also the
        per-leaf one of the same stacks (bitwise), the first step's stacks
        kept for the replicated comparison."""
        out = plain_rs(stacks, **kw)
        if log.check:
            label, log.label = log.label, "check"
            before = dict(ring.LAUNCHES)
            mpi.set_config(fuse_max_bytes=0)
            try:
                per_leaf = plain_rs(stacks, **kw)
            finally:
                mpi.set_config(fuse_max_bytes=fuse0)
            fused_eq.append(all(torch.equal(a, b)
                                for a, b in zip(out, per_leaf)))
            del per_leaf
            exclude(before)
            log.label = label
            if label == "warm-up":
                captured["stacks"] = list(stacks)
        return out

    @torch.no_grad()
    def replicated_rel():
        """Per-leaf rel. L2 of the first step's update against a replicated
        step from the same parameters, state and gradient stacks: the mean
        by the fused ring allreduce, Adam on the full tensors."""
        before = dict(ring.LAUNCHES)
        new_full = recipes.fsdp_unshard_rank_major(params, dims)
        rel = []
        for i, st in zip(sharded, captured.pop("stacks")):
            buf = st.clone()
            fusion.fused_allreduce_rank_major_([buf], backend="pallas",
                                               op="mean")
            g = buf[0].movedim(0, dims[i])
            u, _ = tx.update(g, tx.init(full[i]))
            d_rep = mpi.optim.apply_updates(full[i], u) - full[i]
            d_fsdp = new_full[i] - full[i]
            rel.append(float((d_fsdp - d_rep).norm()
                             / d_rep.norm().clamp_min(1e-30)))
            del buf, g, u, d_rep, d_fsdp
        del new_full
        exclude(before)
        worst = max(range(len(rel)), key=rel.__getitem__)
        return rel[worst], names[sharded[worst]]

    restore = tap_rank_major_routes(torch, mpi, ring, log)
    fusion.fused_reduce_scatter_rank_major = checked_rs
    torch.cuda.synchronize()
    for mod in ops.values():
        mod.reset_launches()
    schedule = (["warm-up"] + [f"timed {i}" for i in range(FSDP_TIMED_STEPS)]
                + ["resident"])
    losses, step_ms, rep = [], [], None
    try:
        for label in schedule:
            mpi.set_config(chunk_bytes=ZERO_CONFIGS[
                "resident" if label == "resident" else "chunked"])
            log.label, log.check = label, not label.startswith("timed")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, state, loss = step(params, state, tok, tok)
            end.record()
            losses.append(loss)
            if label == "warm-up":
                rep = replicated_rel()
            end.synchronize()
            if label.startswith("timed"):
                step_ms.append(start.elapsed_time(end))
    finally:
        restore()
        fusion.fused_reduce_scatter_rank_major = plain_rs
        mpi.set_config(chunk_bytes=ZERO_CONFIGS["chunked"])
    launches = {k: v for mod in ops.values() for k, v in mod.LAUNCHES.items()}
    for k in ring.KERNELS:
        launches[k] -= excluded[k]
    vector = {k: {"all": ring.LAUNCHES[k], "vector": ring.VECTOR_LAUNCHES[k]}
              for k in FSDP_ROWS}
    losses = [float(v) for v in losses]
    checked = [e for e in log if e["bitwise"] is not None]
    per_step = {}
    for e in log:
        if e["label"].startswith("timed"):
            d = per_step.setdefault(e["label"], {})
            d[e["verb"]] = d.get(e["verb"], 0.0) + e["events"][0].elapsed_time(
                e["events"][1])
    leg_ms = {v: statistics.median(d[v] for d in per_step.values())
              for v in ("all_gather", "reduce_scatter")}
    calls = {v: sum(e["verb"] == v for e in log
                    if e["label"] == "timed 0")
             for v in ("all_gather", "reduce_scatter")}

    def one_step():
        nonlocal params, state
        params, state, _ = step(params, state, tok, tok)

    torch.cuda.reset_peak_memory_stats()
    one_step()
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    syncs = count_host_syncs(torch, one_step)
    profile = step_profile(torch, one_step, step_parts=FSDP_STEP_PARTS)
    # The step's layout copies alone, on the same shapes: each dim-1 leaf's
    # shards to the tile layout, its gathered leaf and its gradient shards
    # back (step.layout_copy_bytes).
    moved = [(p, d) for p, d in zip(params, dims) if d]
    tiles = [p.movedim(d + 1, 1).contiguous() for p, d in moved]

    def layout_copies():
        for (p, d), t in zip(moved, tiles):
            p.movedim(d + 1, 1).contiguous()
            t.reshape(-1, *t.shape[2:]).movedim(0, d).contiguous()
            t.movedim(1, d + 1).contiguous()

    layout_ms = time_ms(torch, layout_copies)
    del tiles
    persistent_after = rank_bytes() / (3 * full_bytes)

    # The process-world form at world one (NCCL) against the rank-major
    # form at n = 1: the same parameters and the whole batch.
    wstep, wp, ws = recipes.make_fsdp_train_step(model, tx, full,
                                                 loss_fn=loss_fn)
    wp, ws, wloss = wstep(wp, ws, tok, tok)
    rstep, rp, rs = recipes.make_fsdp_train_step_rank_major(
        model, tx, full, 1, loss_fn=loss_fn)
    rp, rs, rloss = rstep(rp, rs, tok, tok)
    world_rel, world_bitwise = 0.0, True
    with torch.no_grad():
        for p0, a, b in zip(full, wp, rp):
            b = b[0] if b.dim() > a.dim() else b
            world_bitwise &= bool(torch.equal(a, b))
            d = (b - p0).norm().clamp_min(1e-30)
            world_rel = max(world_rel, float((a - b).norm() / d))
    world_loss_equal = bool(torch.equal(wloss, rloss))
    del wstep, wp, ws, rstep, rp, rs

    med = statistics.median(step_ms)
    emit({"phase": "fsdp_dp", "ranks": n, "optimizer": f"adam({ZERO_LR})",
          "config": dict(LM, batch=BATCH, seq=SEQ, dtype="bfloat16"),
          "leaves": len(full), "sharded_leaves": len(sharded),
          "replicated_leaves": [nm for nm, d in zip(names, dims)
                                if d is None],
          "dim1_leaves": sum(d == 1 for d in dims),
          "steps": schedule, "losses": losses,
          "step_ms": step_ms, "median_step_ms": med,
          "min_step_ms": min(step_ms), "max_step_ms": max(step_ms),
          "tokens_per_s": BATCH * SEQ / (med / 1e3),
          "gather_ms_per_step": leg_ms["all_gather"],
          "reduce_scatter_ms_per_step": leg_ms["reduce_scatter"],
          "calls_per_step": calls,
          "layout_copy_bytes_per_step": step.layout_copy_bytes,
          "layout_copy_ms_per_step": layout_ms,
          "step_device_profile": profile,
          "peak_mem_bytes_step": step_peak,
          "peak_mem_bytes_with_check": max(log.peak,
                                           torch.cuda.max_memory_allocated()),
          "persistent_vs_replicated": persistent,
          "persistent_vs_replicated_after": persistent_after,
          "persistent_bytes_per_rank": rank_bytes(),
          "replicated_bytes": 3 * full_bytes,
          "bitwise_vs_plain": all(e["bitwise"] for e in checked),
          "n_collectives_checked": len(checked),
          "all_gather_rows_equal": all(e.get("rows_equal", True)
                                       for e in checked),
          "fused_rs_equals_per_leaf": fused_eq,
          "replicated_max_rel_l2": rep[0], "replicated_worst_leaf": rep[1],
          "replicated_tolerance": ZERO_RTOL,
          "world_one_loss_equal": world_loss_equal,
          "world_one_updates_bitwise": world_bitwise,
          "world_one_max_rel_l2": world_rel,
          "host_syncs_per_step": syncs, "launches": launches,
          "check_launches": {k: v for k, v in excluded.items() if v},
          "launches_on_16_byte_path": vector})
    # A checked step: a gather a sharded leaf, a fused reduce-scatter a
    # bucket, and the per-leaf check's reduce-scatter a leaf.
    check(calls["all_gather"] == len(sharded)
          and calls["reduce_scatter"] < len(sharded)
          and len(checked) == 2 * (2 * len(sharded)
                                   + calls["reduce_scatter"]),
          f"FSDP collectives: {calls} a step, {len(checked)} checked")
    check(all(e["bitwise"] for e in checked),
          "an FSDP gather or reduce-scatter differs from the plain ring")
    check(all(e.get("rows_equal", True) for e in checked),
          "the all-gathered ranks differ")
    check(len(fused_eq) == 2 and all(fused_eq),
          "the fused reduce-scatter differs from the per-leaf one")
    check(rep[0] <= ZERO_RTOL, f"FSDP vs replicated Adam: {rep}")
    check(persistent <= FSDP_PERSISTENT_MAX
          and persistent_after <= FSDP_PERSISTENT_MAX,
          f"persistent bytes {persistent} / {persistent_after} of "
          f"replicated")
    check(all(math.isfinite(v) for v in losses), f"non-finite {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(syncs == 0, f"{syncs} host-device synchronizations in a step")
    check(world_loss_equal and world_rel <= ZERO_RTOL,
          f"the world-one step vs rank-major n = 1: loss equal "
          f"{world_loss_equal}, updates {world_rel}")
    for name in FSDP_ROWS + tuple(SOURCES)[:6]:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              f"FSDP path")
    return launches


def tree_verbs_phase(torch, mpi, ring, dev):
    """The in-axis verbs over a tree (collectives_bench.py's _pytree_mode
    tree) per leaf (fuse_max_bytes 0) and fused (the default): the
    process-world allreduce and reduce-scatter across the NCCL world of
    one, and the rank-major fused reduce-scatter of RING_N ranks on
    "pallas".  Launches counted at the selector's implementation calls, ms
    by CUDA events; fused and per leaf held bitwise equal."""
    fusion, sel = mpi.fusion, mpi.selector
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    fuse0 = mpi.config().fuse_max_bytes
    rows, bitwise = [], {}
    for nbytes in TREE_SIZES:
        per_leaf = max(8, nbytes // TREE_LEAVES // 4)
        dts = [torch.float32 if i % 2 == 0 else torch.bfloat16
               for i in range(TREE_LEAVES)]
        tree = {f"p{i:03d}": torch.randn(per_leaf, generator=g,
                                         device=dev).to(dt)
                for i, dt in enumerate(dts)}
        stacks = [torch.randn(RING_N, per_leaf, generator=g,
                              device=dev).to(dt) for dt in dts]
        tree_bytes = sum(t.numel() * t.element_size() for t in tree.values())
        cases = (
            ("allreduce_in_axis", "allreduce", "xla",
             lambda: list(mpi.allreduce_in_axis(tree).values())),
            ("reduce_scatter_in_axis", "reduce_scatter", "xla",
             lambda: list(mpi.reduce_scatter_in_axis(tree).values())),
            ("reduce_scatter_rank_major", "reduce_scatter_rank_major",
             "pallas", lambda: fusion.fused_reduce_scatter_rank_major(
                 stacks, backend="pallas")))
        for name, op, backend, fn in cases:
            outs = {}
            for mode, max_bytes in (("per-leaf", 0), ("fused", fuse0)):
                mpi.set_config(fuse_max_bytes=max_bytes)
                impl, calls = sel.available(op)[backend], []

                def counted(*a, _impl=impl, **k):
                    calls.append(1)
                    return _impl(*a, **k)

                sel.register(op, backend, counted)
                try:
                    before = dict(ring.LAUNCHES)
                    out = fn()
                    launched = [k for k, v in ring.LAUNCHES.items()
                                if v != before[k]]
                finally:
                    sel.register(op, backend, impl)
                outs[mode] = out
                rows.append({"verb": name, "mode": mode, "bytes": nbytes,
                             "tree_bytes": tree_bytes,
                             "leaves": TREE_LEAVES,
                             "fuse_max_bytes": max_bytes,
                             "launches": len(calls), "rows": launched,
                             "ms": time_ms(torch, fn)})
            mpi.set_config(fuse_max_bytes=fuse0)
            bitwise[f"{name} {nbytes}"] = all(
                torch.equal(a, b) for a, b in zip(outs["per-leaf"],
                                                  outs["fused"]))
            del outs
    emit({"phase": "tree_verbs", "ranks_rank_major": RING_N,
          "world": mpi.size(), "rows": rows,
          "fused_equals_per_leaf": bitwise})
    check(all(bitwise.values()), f"fused differs from per leaf: {bitwise}")
    for r in rows:
        want = TREE_LEAVES if r["mode"] == "per-leaf" else 2
        check(r["launches"] == want, f"{r['verb']} {r['mode']} "
              f"{r['bytes']}: {r['launches']} launches, not {want}")


def allreduce_busbw_phase(torch, mpi, ring, dev):
    """The allreduce bus-bandwidth table (collectives_bench.py :808-947,
    the port's utils.metrics.allreduce_bus_bandwidth): RING_N ranks
    rank-major on the card
    at BUSBW_SIZES bytes a rank; the allreduce on "pallas" with
    pallas_bidirectional off and on and on the stock route, the allgather
    on "pallas" and the stock route.  Each: ms (median of 10 by CUDA
    events), the row it launched, algbw (algo bytes / time: the size, n x
    size for the allgather) and busbw (the allreduce's algbw x 2(n-1)/n;
    the allgather's as collectives_bench.py reports it, its algbw); each
    result against the plain ring (bitwise; the stock allreduce's left
    fold within BUSBW_STOCK_RTOL).  A failing call fails the run.  Every
    kernel counter is set to 0 just before and read just after."""
    from torchmpi_tpu_torch.utils import metrics

    n = RING_N
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    lines = []
    ring.reset_launches()
    for nbytes in BUSBW_SIZES:
        x = torch.rand(n, nbytes // 4, generator=g, device=dev)
        for op, backend, bidir in (("allreduce", "pallas", False),
                                   ("allreduce", "pallas", True),
                                   ("allreduce", "xla", False),
                                   ("allgather", "pallas", False),
                                   ("allgather", "xla", False)):
            mpi.set_config(pallas_bidirectional=bidir)
            verb = getattr(mpi, f"{op}_rank_major")

            def fn(verb=verb, backend=backend):
                return verb(x, backend=backend)

            before = dict(ring.LAUNCHES)
            out = fn()
            launched = [k for k, v in ring.LAUNCHES.items()
                        if v != before[k]]
            plain = (ring.ring_allreduce_plain(x) if op == "allreduce"
                     else ring.ring_all_gather_plain(x))
            exact = bool(torch.equal(out, plain))
            err = float((out - plain).abs().max() / plain.abs().max())
            del out, plain
            ms = time_ms(torch, fn)
            algbw = nbytes * (n if op == "allgather" else 1) / ms / 1e6
            lines.append({
                "op": op, "backend": backend, "bidirectional": bidir,
                "bytes": nbytes, "ranks": n, "rows": launched, "ms": ms,
                "algbw_GBs": algbw,
                "busbw_GBs": (metrics.allreduce_bus_bandwidth(
                    nbytes, n, ms / 1e3) if op == "allreduce" else algbw),
                "bitwise_vs_plain_ring": exact, "max_rel_err": err,
                "hops": BUSBW_HOPS})
        mpi.set_config(pallas_bidirectional=False)
        del x
    launches = dict(ring.LAUNCHES)
    emit({"phase": "allreduce_busbw", "hops": BUSBW_HOPS, "rows": lines,
          "launches": launches})
    for r in lines:
        stock_fold = r["op"] == "allreduce" and r["backend"] == "xla"
        check(r["bitwise_vs_plain_ring"] or (
            stock_fold and r["max_rel_err"] <= BUSBW_STOCK_RTOL),
            f"{r['op']} {r['backend']} {r['bytes']}: against the plain "
            f"ring {r['max_rel_err']}")
        check(r["backend"] == "xla" or len(r["rows"]) == 1,
              f"{r['op']} {r['bytes']}: rows {r['rows']}")
    for name in BUSBW_ROWS:
        check(launches[name] > 0, f"{name} never launched in the table")
    return launches



def device_busy(torch, prof, window_s: float) -> dict:
    """The card's busy share of a profiled window: the union of the device
    events' intervals (kernels and copies, all streams) over the window,
    and the copies' own device ms.  None where the profiler recorded no
    device event."""
    # The profiler's raw events: building its FunctionEvent tree for
    # thousands of kernels would take seconds.
    spans, copy_ns = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        lo, hi = e.start_ns(), e.end_ns()
        if hi > lo:
            spans.append((lo, hi))
            if "Memcpy" in e.name() or "Memset" in e.name():
                copy_ns += hi - lo
    if not spans:
        return {"busy_share": None, "device_events": 0}
    spans.sort()
    busy, (cur_lo, cur_hi) = 0, spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return {"busy_share": busy / 1e9 / window_s, "busy_ms": busy / 1e6,
            "copies_ms": copy_ns / 1e6, "device_events": len(spans)}


class PSWorker:
    """One downpour worker of the phase: examples/alexnet_downpour.py's
    ``downpour_step`` (Adam, an axpy push at alpha 1 / PS_WORKERS, a
    prefetch at step s adopted at s + 1) on batches gathered on the card
    from the data copied there once (the example copies each batch from
    the host, a host sync a step)."""

    def __init__(self, torch, mpi, model, ps, X, Y, seed, alpha):
        import numpy as np

        self.model, self.ps = model, ps
        self.X, self.Y, self.alpha = X, Y, alpha
        self.names, self.params = zip(*model.named_parameters())
        self.tx = mpi.optim.adam(PS_LR)
        # Every step's batch indices, drawn up front and copied to the card
        # once: a host-made index tensor copied in each step would be a
        # host sync of its own.
        draws = (PS_CHECK_PUSHES + 1 + PS_TIMED_STEPS + PS_PROBE_STEPS
                 + PS_CKPT_STEPS)
        self.idx = torch.from_numpy(np.random.RandomState(seed).randint(
            0, PS_IMAGES, size=(draws, PS_BATCH))).to(X.device)
        self.draws = 0
        self.reset()

    def reset(self):
        """Adam from zero, no fetch in flight, the step count at 0."""
        self.states = [self.tx.init(p.detach()) for p in self.params]
        self.fetch, self.step, self.last_push = None, 0, None
        self.losses, self.step_s, self.record = [], [], None

    def run_step(self):
        from torchmpi_tpu_torch.examples.alexnet_downpour import \
            downpour_step

        t0 = time.perf_counter()
        idx = self.idx[self.draws]
        self.draws += 1
        x = self.X.index_select(0, idx).permute(0, 3, 1, 2)
        y = self.Y.index_select(0, idx)
        loss, self.last_push, ups, self.fetch = downpour_step(
            self.model, self.names, self.params, self.tx, self.states,
            self.ps, x, y, self.alpha, self.fetch, self.step, PS_FETCH_EVERY)
        if self.record is not None:
            self.record.append(ups)
        self.losses.append(loss)
        self.step += 1
        self.step_s.append(time.perf_counter() - t0)


def _flat_host(torch, mpi, tree):
    """A tree's flat float32 vector as numpy, for the checks."""
    return mpi.utils.tree.flatten_f32(tree)[0].cpu().numpy()


def _bits_equal(a, b) -> bool:
    import numpy as np

    return a.shape == b.shape and bool(np.array_equal(a.view(np.uint32),
                                                      b.view(np.uint32)))


def ps_fold_check(torch, mpi, ps, worker, params0) -> int:
    """Checks (a) and (b) of downpour_ps at full width: one worker,
    PS_CHECK_PUSHES pushes; the center is the numpy float32 fold c +=
    alpha * u (two roundings), and receive() gives it back bitwise on the
    card.  Raises on a mismatch; the center is reset to params0 at the
    end."""
    import numpy as np

    worker.record = []
    for _ in range(PS_CHECK_PUSHES):
        worker.run_step()
    worker.last_push.wait()
    alpha = np.float32(worker.alpha)
    want = _flat_host(torch, mpi, params0)
    for u in worker.record:
        want = want + alpha * _flat_host(torch, mpi, u)
    got = ps.receive().wait()
    check(next(iter(got.values())).is_cuda, "receive() left the card")
    check(_bits_equal(_flat_host(torch, mpi, got), want),
          "(a)/(b) the center is not the float32 fold of the pushes")
    worker.record = None
    ps.send(params0, rule="copy").wait()
    return PS_CHECK_PUSHES


def ps_transport_checks(torch, mpi, ps, params0, dev) -> dict:
    """Checks (c)-(e) of downpour_ps at full width; each raises on a
    mismatch.  The center is reset to params0 at the end."""
    import numpy as np

    from torchmpi_tpu_torch.examples import common

    out = {}
    c0 = _flat_host(torch, mpi, params0)
    # (c) two pushes back to back from one thread: their bitwise sum.
    g = torch.Generator(dev).manual_seed(SEED + 41)
    rand = [{n: torch.randn(p.shape, device=dev, generator=g)
             for n, p in params0.items()} for _ in range(4)]
    ps.send(params0, rule="zero").wait()
    h1, h2 = ps.send(rand[0], rule="add"), ps.send(rand[1], rule="add")
    h1.wait()
    h2.wait()
    u0, u1 = _flat_host(torch, mpi, rand[0]), _flat_host(torch, mpi, rand[1])
    check(_bits_equal(_flat_host(torch, mpi, ps.receive().wait()), u0 + u1),
          "(c) back-to-back pushes are not their bitwise sum")
    # (d) two threads pushing concurrently through the one client, each on
    # its own stream: the bitwise sum of both (from zero, in either order).
    ps.send(params0, rule="zero").wait()
    torch.cuda.synchronize(dev)
    common.run_workers(lambda i: ps.send(rand[2 + i], rule="add").wait(), 2,
                       dev)
    u2, u3 = _flat_host(torch, mpi, rand[2]), _flat_host(torch, mpi, rand[3])
    check(_bits_equal(_flat_host(torch, mpi, ps.receive().wait()), u2 + u3),
          "(d) concurrent pushes of two threads are not their bitwise sum")
    # (e) one elastic exchange against the server's formula in numpy.
    ps.send(params0, rule="copy").wait()
    p = {n: params0[n] + rand[0][n] * 1e-2 for n in params0}
    a = np.float32(PS_ELASTIC_ALPHA)
    delta = ps.send(p, rule="elastic", alpha=float(a)).wait()
    d = a * (_flat_host(torch, mpi, p) - c0)
    check(_bits_equal(_flat_host(torch, mpi, delta), d),
          "(e) the elastic delta differs from alpha * (p - c)")
    check(_bits_equal(_flat_host(torch, mpi, ps.receive().wait()), c0 + d),
          "(e) the center after the elastic exchange differs from c + delta")
    out.update(c_back_to_back=True, d_two_threads=True,
               e_elastic_alpha=float(a))
    ps.send(params0, rule="copy").wait()
    return out


def downpour_ps_phase(torch, mpi, dev):
    """This slice's main path: BASELINE config 4, AlexNet async downpour
    at full width (PS_* above), through mpi.parameterserver.init, send,
    receive, wait and examples.common.run_workers.  First checks (a)-(e)
    (ps_transport_checks while the host data is made on a thread,
    ps_fold_check), then the segments: a warm-up step a worker,
    PS_TIMED_STEPS timed with nothing watching (img/s over both workers
    from the first timed step's start to the last push applied; each
    worker's step ms; the push split into its device-to-host wait and the
    native enqueue and the fetch into its native wait and the copy to the
    card; the server's cycle costs; peak memory; the table's kernel
    launches, which must be 0: AlexNet is convolutions and dense layers),
    PS_PROBE_STEPS watched (the card's busy share, torch.profiler over the
    window; host syncs a step: the event waits, counted where
    torch.cuda.Event.synchronize is called, which must be one a push, and
    the synchronizations PyTorch's sync debug mode sees, which must be
    none), then PS_CKPT_STEPS while worker 0's checkpoint.save_async of a
    fresh center and its Adam state is written (f: restored bitwise
    after)."""
    import shutil
    import tempfile
    import threading

    from torch.profiler import ProfilerActivity, profile

    from torchmpi_tpu_torch.examples import common
    from torchmpi_tpu_torch.ops import flash, ring, xent
    from torchmpi_tpu_torch.utils import checkpoint
    from torchmpi_tpu_torch.utils import data as dutil

    t_phase = time.perf_counter()
    timings = {}
    # The host data, made on a thread of its own (numpy releases the GIL
    # in its fills) while the models are built and checks (c)-(e) run.
    host_data = {}

    def make_data():
        t = time.perf_counter()
        try:
            host_data["xy"] = dutil.synthetic_image_classification(
                PS_IMAGES, image_shape=(PS_IMAGE, PS_IMAGE, 3),
                num_classes=PS_CLASSES, seed=SEED + 52)
        except Exception as e:  # noqa: BLE001 — raised by the phase
            host_data["error"] = e
        host_data["s"] = time.perf_counter() - t

    maker = threading.Thread(target=make_data)
    maker.start()

    def make(seed=SEED + 51):
        return mpi.models.AlexNet(
            PS_CLASSES, dropout=0.0, image_size=PS_IMAGE, device=dev,
            generator=torch.Generator(dev).manual_seed(seed))

    model0 = make()
    params0 = common.params_tree(model0)
    n_params = sum(p.numel() for p in params0.values())
    check(n_params == PS_PARAMS, f"AlexNet has {n_params} parameters")
    ps = mpi.parameterserver.init(params0, num_shards=PS_SHARDS)
    ckpt_dir = tempfile.mkdtemp(prefix="ps_ckpt_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        t0 = time.perf_counter()
        checks = ps_transport_checks(torch, mpi, ps, params0, dev)
        timings["checks_c_to_e_s"] = time.perf_counter() - t0
        replicas = [make() for _ in range(PS_WORKERS)]
        t0 = time.perf_counter()
        maker.join()
        if "error" in host_data:
            raise host_data["error"]
        Xh, Yh = host_data.pop("xy")
        X = torch.from_numpy(Xh).to(dev)
        Y = torch.from_numpy(Yh).to(dev).long()
        host_data_bytes = Xh.nbytes
        del Xh, Yh
        timings.update(data_s=host_data["s"],
                       data_wait_and_copy_s=time.perf_counter() - t0)
        workers = [PSWorker(torch, mpi, m, ps, X, Y, SEED + 53 + w,
                            1.0 / PS_WORKERS)
                   for w, m in enumerate(replicas)]
        t0 = time.perf_counter()
        checks["a_fold_pushes"] = ps_fold_check(torch, mpi, ps, workers[0],
                                                params0)
        timings["checks_a_b_s"] = time.perf_counter() - t0
        for m, wk in zip(replicas, workers):
            common.load_params(m, params0)
            wk.reset()
        torch.cuda.synchronize(dev)

        segments = (("warmup", 1), ("timed", PS_TIMED_STEPS),
                    ("probe", PS_PROBE_STEPS), ("ckpt", PS_CKPT_STEPS))
        # The harness's own event waits go around the probe's count.
        event_sync = torch.cuda.Event.synchronize
        barrier = threading.Barrier(PS_WORKERS + 1)
        saved = {}

        def body(w):
            wk = workers[w]
            try:
                for name, steps in segments:
                    barrier.wait()
                    if name == "ckpt" and w == 0:
                        # A fresh center and this worker's Adam state,
                        # written while the other worker's step runs.
                        center = ps.receive().wait()
                        tree = {"center": center, "adam": list(wk.states)}
                        t = time.perf_counter()
                        h = checkpoint.save_async(ckpt_dir, tree, step=1)
                        saved.update(tree=tree, handle=h, t_start=t,
                                     t_call=time.perf_counter())
                    for _ in range(steps):
                        wk.run_step()
                    # The segment's end: the last push applied and this
                    # worker's stream drained (an event wait, which the
                    # sync debug mode does not flag, past the probe's
                    # count: the harness's wait, not a step's).
                    wk.last_push.wait()
                    done = torch.cuda.Event()
                    done.record()
                    event_sync(done)
                    barrier.wait()
            except BaseException:
                barrier.abort()
                raise

        errors = []

        def run():
            try:
                common.run_workers(body, PS_WORKERS, dev)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        t_segments = time.perf_counter()
        runner = threading.Thread(target=run)
        runner.start()
        result = {}
        try:
            for name, steps in segments:
                t_seg = time.perf_counter()
                if name == "timed":
                    ps.client.reset_staging()
                    stats0 = ps.stats()
                    torch.cuda.reset_peak_memory_stats(dev)
                    for mod in (flash, xent, ring):
                        mod.reset_launches()
                    for wk in workers:
                        wk.step_s = []
                    barrier.wait()
                    t = time.perf_counter()
                    barrier.wait()
                    window_s = time.perf_counter() - t
                    stats1 = ps.stats()
                    result.update(
                        window_s=window_s,
                        peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                        table_launches=sum(
                            sum(mod.LAUNCHES.values())
                            for mod in (flash, xent, ring)),
                        staging=ps.client.staging(),
                        server={k: stats1[k] - stats0[k] for k in stats1},
                        step_s=[list(wk.step_s) for wk in workers])
                elif name == "probe":
                    waits = []

                    def counted(event):
                        waits.append(1)
                        return event_sync(event)

                    prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.start()
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        torch.cuda.Event.synchronize = counted
                        torch.cuda.set_sync_debug_mode("warn")
                        try:
                            barrier.wait()
                            t = time.perf_counter()
                            barrier.wait()
                            probe_s = time.perf_counter() - t
                        finally:
                            torch.cuda.set_sync_debug_mode("default")
                            torch.cuda.Event.synchronize = event_sync
                            prof.stop()
                    result.update(
                        probe_s=probe_s, probe_event_waits=len(waits),
                        sync_debug_warnings=sum(
                            "synchronizing CUDA operation" in str(c.message)
                            for c in caught),
                        sync_debug_sites=sorted({
                            f"{os.path.basename(c.filename)}:{c.lineno}"
                            for c in caught if "synchronizing CUDA "
                            "operation" in str(c.message)}),
                        busy=device_busy(torch, prof, probe_s))
                elif name == "ckpt":
                    barrier.wait()
                    while "handle" not in saved and not errors:
                        time.sleep(0.005)
                    h = saved.get("handle")
                    while h is not None and not h.done():
                        time.sleep(0.005)
                    saved["t_done"] = time.perf_counter()
                    barrier.wait()
                else:
                    barrier.wait()
                    barrier.wait()
                timings[f"{name}_segment_s"] = time.perf_counter() - t_seg
        except threading.BrokenBarrierError:
            pass  # a worker failed: its error is raised below
        except BaseException:
            barrier.abort()
            runner.join()
            raise
        runner.join()
        if errors:
            raise errors[0]
        timings["segments_s"] = time.perf_counter() - t_segments

        # (f) the checkpoint, restored bitwise.
        saved["handle"].wait(60.0)
        tree = saved["tree"]
        t = time.perf_counter()
        template = {"center": {n: torch.zeros_like(v)
                               for n, v in tree["center"].items()},
                    "adam": [mpi.optim.adam(PS_LR).init(torch.zeros_like(
                        s.mu)) for s in tree["adam"]]}
        back = checkpoint.restore(ckpt_dir, template, step=1)
        restore_s = time.perf_counter() - t
        ok = all(torch.equal(back["center"][n], tree["center"][n])
                 for n in tree["center"])
        ok = ok and all(
            int(b.count) == s.count and torch.equal(b.mu, s.mu)
            and torch.equal(b.nu, s.nu)
            for b, s in zip(back["adam"], tree["adam"]))
        check(ok, "(f) the restored checkpoint differs from what was saved")
        ckpt_bytes = os.path.getsize(saved["handle"].path)
        write_s = saved["t_done"] - saved["t_call"]
        ckpt = {"bytes": ckpt_bytes, "save_async_call_s":
                saved["t_call"] - saved["t_start"], "write_s": write_s,
                "mb_per_s": ckpt_bytes / 1e6 / write_s if write_s > 0
                else None, "restore_s": restore_s,
                "overlapped_steps": PS_CKPT_STEPS, "restored_bitwise": True}
        losses = [[float(v) for v in wk.losses] for wk in workers]
        center = ps.receive().wait()
        finite = all(bool(torch.isfinite(v).all()) for v in center.values())
    finally:
        ps.shutdown()
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    st, sv = result["staging"], result["server"]
    step_ms = [[1e3 * v for v in w] for w in result["step_s"]]
    timed_images = PS_WORKERS * PS_TIMED_STEPS * PS_BATCH
    pushes = st["pushes"]
    probe_pushes = PS_WORKERS * PS_PROBE_STEPS
    host_syncs = result["probe_event_waits"] + result["sync_debug_warnings"]
    emit({"phase": "downpour_ps", "workers": PS_WORKERS, "shards": PS_SHARDS,
          "batch_a_worker": PS_BATCH, "image": PS_IMAGE,
          "classes": PS_CLASSES, "params": n_params,
          "flat_bytes": 4 * n_params, "host_data_bytes": host_data_bytes,
          "transport": PS_TRANSPORT,
          "timed_steps_a_worker": PS_TIMED_STEPS,
          "img_per_s": timed_images / result["window_s"],
          "window_s": result["window_s"],
          "step_ms": [{"median": statistics.median(w), "min": min(w),
                       "max": max(w)} for w in step_ms],
          "push": {"count": pushes,
                   "d2h_and_wait_ms": 1e3 * st["push_d2h_wait_s"] / pushes,
                   "native_enqueue_ms": 1e3 * st["push_enqueue_s"] / pushes},
          "fetch": {"count": st["fetches"],
                    "native_wait_ms": (1e3 * st["fetch_wait_s"]
                                       / max(1, st["fetches"])),
                    "h2d_device_ms": (st["fetch_h2d_ms"]
                                      / max(1, st["fetches"]))},
          "server": sv,
          "probe_steps_a_worker": PS_PROBE_STEPS,
          "probe_s": result["probe_s"],
          "host_syncs_per_step": host_syncs / probe_pushes,
          "event_waits": result["probe_event_waits"],
          "sync_debug_warnings": result["sync_debug_warnings"],
          "sync_debug_sites": result["sync_debug_sites"],
          "peak_mem_bytes": result["peak_mem_bytes"],
          "card_busy": result["busy"], "table_launches":
          result["table_launches"], "checks": checks, "checkpoint": ckpt,
          "losses": losses, "timings": timings,
          "seconds": time.perf_counter() - t_phase})
    check(all(math.isfinite(v) for w in losses for v in w),
          f"non-finite losses {losses}")
    check(finite, "the center is not finite")
    check(pushes == PS_WORKERS * PS_TIMED_STEPS,
          f"{pushes} pushes in the timed steps")
    check(result["probe_event_waits"] == probe_pushes
          and result["sync_debug_warnings"] == 0,
          f"host syncs: {result['probe_event_waits']} event waits for "
          f"{probe_pushes} pushes, {result['sync_debug_warnings']} other")
    check(result["table_launches"] == 0,
          "a kernel of the table launched on the parameter-server path")
    check(sv["bytes_in"] == pushes * 4 * n_params,
          f"server bytes_in {sv['bytes_in']} for {pushes} pushes")


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

    # The kernels (one nvcc a source, all together) and, beside them, the
    # parameter server's and the async writer's host libraries (g++).
    import threading

    from torchmpi_tpu_torch.utils import native

    t0 = time.perf_counter()
    host = {}

    def build_host():
        try:
            for name in native.LIBS:
                t = time.perf_counter()
                host[name] = {"lib": str(native.build(name)),
                              "seconds": time.perf_counter() - t}
        except Exception as e:  # noqa: BLE001 — raised below
            host["error"] = e

    host_build = threading.Thread(target=build_host)
    host_build.start()
    _build.build()
    host_build.join()
    if "error" in host:
        raise host["error"]
    ptxas = {n: ptxas_summary(log) for n, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": str(_build.BUILD_DIR), "ptxas": ptxas, "host_libs": host,
          "card_uuid": nvidia_smi("uuid")})

    ops = {"flash": flash, "xent": xent}
    dev = mpi.init()
    try:
        rows = kernel_phase(torch, flash, dev)
        rows += xent_kernel_phase(torch, xent, dev)
        rows += xent_f32_phase(torch, xent, dev)
        rows += ring_kernel_phase(torch, mpi, ring, dev)
        rows += ring_rs_ag_kernel_phase(torch, ring, dev)
        train_phase(torch, mpi, ops, dev, "dense")
        torch.cuda.empty_cache()
        # The main path of slices 1 and 2: stage B', the fused LM-head loss.
        launches, _ = train_phase(torch, mpi, ops, dev, "fused")
        torch.cuda.empty_cache()
        consistency_phase(torch, mpi, dev)
        torch.cuda.empty_cache()
        # The main path of the float32 head (slices 11, 14 and 15): stage B'
        # at the model's default float32, the forward and the backward on
        # wgmma_tf32.
        _, routes = train_phase(torch, mpi, ops, dev, "fused", torch.float32)
        launches.update({f"{n}[{r}]": routes[n][r]
                         for n, r in XENT_F32_ROUTES.items()})
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
        # The main path of slice 19: the same ResNet-50 step with its routes
        # measured and planned (backend "auto": rows 8 and 11 against the
        # stock route), the planner's host cost, compat.py.
        auto_launches, dev = auto_dp_phase(torch, mpi, dict(ops, ring=ring),
                                           dev)
        torch.cuda.empty_cache()
        # The main paths of slice 13: the nine verbs, staged and async, of
        # RING_N ranks on the card and across the NCCL world of one; then
        # ResNet-50 with its sync fired from the backward hooks on a side
        # stream (rows 8 and 11), ZeRO-1 presynced (row 10).
        async_verbs_phase(torch, mpi, ring, dev)
        torch.cuda.empty_cache()
        ov_launches = overlap_dp_phase(torch, mpi, dict(ops, ring=ring), dev)
        torch.cuda.empty_cache()
        # The main path of slice 16: the flagship as FSDP of RING_N ranks on
        # the card (rows 1-6 in the ranks' steps, 9, 10, 13 and 14 for the
        # gathers and the gradient reduce-scatter); the tree verbs; the
        # allreduce bus-bandwidth table (rows 7, 8, 11, 12; 10 and 14).
        fsdp_launches = fsdp_dp_phase(torch, mpi, dict(ops, ring=ring), dev)
        torch.cuda.empty_cache()
        tree_verbs_phase(torch, mpi, ring, dev)
        torch.cuda.empty_cache()
        busbw_launches = allreduce_busbw_phase(torch, mpi, ring, dev)
        torch.cuda.empty_cache()
        # The main path of slice 17: BASELINE config 5, ResNet-50 on a
        # 2 x 2 (dcn x ici) grid of the 4 ranks, hierarchical, int8 error
        # feedback, and the ring kernels per node (rows 8-11).
        hier_launches = hier_dp_phase(torch, mpi, dict(ops, ring=ring), dev)
        torch.cuda.empty_cache()
        # The main path of slice 18: BASELINE config 4, AlexNet async
        # downpour at full width through the parameter server (host
        # threads and loopback TCP; no kernel of the table), checkpoints.
        downpour_ps_phase(torch, mpi, dev)
        torch.cuda.empty_cache()
        cnn_examples_phase(torch, mpi)
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
                   if name in r50_launches else {}),
                **({"overlap_dp": ov_launches[name]}
                   if name in ov_launches else {}),
                **({"fsdp_dp": fsdp_launches[name]}
                   if fsdp_launches.get(name) else {}),
                **({"allreduce_busbw": busbw_launches[name]}
                   if busbw_launches.get(name) else {}),
                **({"hier_dp": hier_launches[name]}
                   if hier_launches.get(name) else {}),
                **({"auto_dp": auto_launches[name]}
                   if auto_launches.get(name) else {})}

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
