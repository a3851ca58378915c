#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (torchmpi_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

needs one CUDA card and the CUDA toolkit (nvcc), and nothing else of the
JAX package.  In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels from ops/csrc with nvcc (sm_90a, one compiler per
   source, in parallel) into build/torch_kernels/: fourteen kernels and
   row 1's residual form (a second launcher of flash_fwd.cu) in seven
   libraries; beside them, with g++, the parameter server's and the
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
   Then the bf16 flash phase (flash_bf16, slice 25): the public entry
   points (flash_attention, with residuals at batch 1, and
   flash_attention_grad forward and backward) on bf16 q / k / v at the
   same shape, every launch on the bf16 route and every output bf16 (the
   residual form's float32); rows 1, 1 res, 2 and 3 against their plain
   versions within 2^-7 x max |ref| and bitwise on a repeat, timed beside
   their bound at the bf16 tensor-core rate and bf16 SDPA;
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
   Then the telemetry slice's main path (obs_dp): the same DP step
   through gradsync.data_parallel_step_rank_major (backend "pallas") with
   Config.obs "metrics": losses and synced gradients bitwise to obs off,
   0 host syncs, the counters equal to the launches (59 buckets a step on
   row 8), the dump through the obs tool (dump, prom, attribute), step ms
   and host us a dispatch with obs on and off in turns, one step under
   "trace" (call sites), one under utils.tracing.trace (a Chrome trace
   naming the flash, xent and ring kernels); and, after the chaos phase,
   the guard phase (guard_dp, the main path of the guard slice): the same
   DP step at depth 2 with guard="numeric" bitwise to the guard off and 0
   host syncs (the tripwire's device ms and the step ms a side in turns),
   a NaN in one rank's gradient skipped (parameters unchanged, one skipped
   step counted) or raised (NumericAnomalyError at the step's boundary)
   and a norm bound tripped; the staged buckets under silent flips at both
   legs, wrong without the guard and bitwise with guard="wire", the
   tm_guard_* counters against FaultPlan.decide; a one-shot poison of the
   parameters rewound by guard.run_guarded (10 steps, a checkpoint every
   3: info rewinds 1 at step 7, recovered step 6, a rewind record on the
   board, no config-epoch bump or re-plan, bitwise to a clean run);
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
   then the restart phase (restart_zero, the main path of the checkpoint
   slice): the same ZeRO-1 flagship at depth 1 (rows 1-6, 9 and 10), each
   step's 4
   losses read to the host and reduced by the staged rank-major
   allreduce, (a) 6 steps through restart.run_with_restarts, a buddy
   checkpoint every 2 steps (keep 2), under a plan of the port's chaos
   tool (a stall at step 5's staged gather, a silent rot at the first
   checkpoint read) and watchdog "break" at 1 s: the hang raised as
   CollectiveHangError on the on_peer_timeout path, step 4 read, its
   digest wrong, repaired from the buddy bit-identically, steps 4 and 5
   replayed, the final parameters and Adam moments (and every step's
   loss) bitwise to 6 plain steps, only steps 4 and 6 left, 0 host syncs
   in a step outside the loss read; each save's seconds and GB/s, the
   recovery's read, verify and repair seconds; (b) save_sharded of the
   final state, the moments as 4 rank-major shards each, restored bitwise
   into a data-less template, a 2-shard template raising by name, the
   files read with plain numpy / json; seconds and GB/s each way;
   then the elastic phase (elastic_zero, the main path of the elastic
   slice): the same ZeRO-1 flagship at depth 1 as an elastic gang of 4
   members (elastic.run_elastic), member 2 killed at step 5 by the chaos
   tool's --shrink 2:5:4: info shrinks 1, view (0, 1, 3), the Adam
   moments re-partitioned over 3 rows, the n = 3 losses and the state at
   the rejoin bitwise to a clean 3-member run from a copy of the
   recovered checkpoint; member 2 admitted back through elastic.admit (a
   thread) and the steps after the boundary bitwise to a clean 4-member
   run from its checkpoint; every reduce-scatter / all-gather at n = 3
   bitwise to the plain ring on the row it reports, one ZeRO-1 update at
   n = 3 within 1e-4 of replicated Adam; the save, recovery, reconcile
   and re-partition seconds and the step ms at n 4 and n 3; the runtime
   is started again after it;
   then the hot-state phase (hotstate_zero, the main path of the hot-state
   slice): the same gang at depth 2 with Config.hotstate "on" and
   hotstate.enable at the end of step 3, the state streamed to the
   buddy's RAM after every step from there (a snapshot every 3rd, deltas
   packed on the card between): (a) --shrink 2:5:4 recovers step 5 from
   RAM, bitwise the true state and a clean 3-member run from it, the
   n = 3 ring calls bitwise; (b) a gang of members 1-4 of slots 0-4 under
   the same kill with step 3's snapshot rotted at hotstate.recv falls to
   disk step 4, counted; (c) then member 1 drained onto spare slot 0 at
   step 6 (hotstate.migrate) with the lease "migrating" and blame --live
   showing it, the spare resumed at step 6 from its RAM, (b) and (c)
   bitwise a clean run from step 4; (d) the card's pack of the real state
   byte-equal to the numpy pack; the blob and state bytes, corrections,
   publish seconds by part, restore seconds and step ms with the tier off
   and armed;
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
13. sequence-parallel phase (longcontext_sp, the main path of the
   sequence-parallel slice): the flagship's widths with 16 kv heads (no
   GQA, as JAX's sequence-parallel impls require), RoPE, bf16 compute, no
   window, over one sequence of 8192 tokens as 4 ranks x 2048 rank-major
   on the card, stage B''s fused loss over the global sequence, SGD lr
   0.02: the residual flash kernel against its plain version at the
   ring's three shard pairs ([1, 2048, 16, 128] f32; the fully masked
   pair exactly NEG_INF / 0 / 0; two calls bitwise; timed beside its
   plain version and, as context, SDPA's forward); ring_flash and
   ulysses_flash attention alone (f32, [1, 8192, 16, 128] over 4 ranks)
   within 1e-4 of flash_attention_grad over the whole sequence; each
   sequence-parallel model's loss and gradients within 2e-2 (rel. L2) of
   the single-device flash model on the same seed weights; one warm-up
   and 8 ring_flash steps, one and 3 ulysses_flash steps (median, min,
   max, tokens/s, peak memory, 0 host syncs, every kernel of each path
   launched, one step profiled by part); the example longcontext_lm
   --devices 4 with ring_flash and with ulysses to the JAX bar; the ring
   through the NCCL world of one equal to flash_attention;
14. expert-parallel phase (moe_ep, the main path of the expert-parallel
   slice): the flagship with its MLP an expert layer over ici (2 experts
   a rank, top-2, capacity factor 2.0; the experts in float32), rank-major
   on a dcn 2 x ici 2 grid, one row of 2048 tokens a rank, the fused loss
   plus 1e-2 of the load-balance losses, SGD lr 0.02: one layer alone at
   the flagship's shapes (f32, k 1 and 2, capacity factor 2.0 and 0.5)
   against a per-token oracle (routing identical, output and gate / w1 /
   w2 gradients within 1e-4 of each reference's largest, two calls
   bitwise); the process world of one (NCCL) bitwise to the rank-major
   form at n = 1; the step's loss and gradients within 2e-2 (rel. L2) of
   each rank's row run alone with all 4 experts local; one warm-up and 8
   steps (median, min, max, tokens/s, peak memory, 0 host syncs, rows 1-6
   launched, every head launch on wgmma, one step profiled by part, the
   share of routes dropped and of slots filled); the example moe_lm
   --devices 4 --dcn 2 --top-k 2 to the JAX bar;
15. tensor- and pipeline-parallel phase (megatron_3d, the main path of
   the N-D world's slice): a stack of 8 Megatron blocks at the flagship's
   widths (D 2048, 16 heads of 128, F 8192, causal, window 1024, flash
   attention, float32; 403 M parameters) rank-major on mesh_shape pp 2 x
   dp 2 x tp 2 (8 ranks on the card), GPipe over pp (4 blocks a stage), 4
   microbatches of 1 x 2048 tokens a dp group, the f / g and dp
   allreduces on backend "pallas", the JAX example's regression loss, SGD
   lr 2e-3: the process world of one (NCCL, pp 1 x dp 1 x tp 1) bitwise
   to the rank-major form at n = 1; one GPipe and one interleaved step (V
   2) against the same blocks applied in order on the card (outputs
   within 3e-4 / 4.8e-4, the loss within 9.9e-7 relative, every gradient
   within rel. L2 1e-4; a control step with TF32 products reported
   beside them), every ring launch bitwise to the plain ring; one warm-up
   and 8 timed steps (median, min, max, tokens/s, peak memory, 0 host
   syncs, rows 1-3 20 launches a step, one step profiled by part and by
   range: the f / g allreduces, the dp mean, the stage shifts); a pushed
   communicator (shape ici 4) planned on its own key; the example
   megatron_pipeline --devices 8 --dp 2, GPipe and interleaved, to the
   JAX bar;
16. serving phase (lm_serving, the main path of the decoding and serving
   slice): the flagship LM at full width (seed weights, float32, TF32 off)
   served by serving.Server over one ReplicaEngine of 16 slots x 2048
   tokens: a burst of 16 live slots times the decode step (median, min,
   max of 24; its bound from the weights and the pool cache it reads; its
   device ms by part: products, attention, cache writes, sampling) and
   counts host syncs (exactly 1 a prefill and 1 a decode step); then 48
   requests from SEED (prompts 128-1024, 32-256 new tokens, 16 sampled at
   temperature 0.8, top-k 40, top-p 0.9) arrive as a Poisson stream at
   load 1.0 on the measured step (benchmarks/serving_bench.py :235) and
   are served under the wall clock: output tokens/s, TTFT and ITL p50 /
   p99, prefill ms by prompt length, peak memory; no kernel of the table
   launches (rows 1-14 counted, 0 each).  Checks: cached against
   recomputed logits within 1e-4 of the largest; greedy streams equal to
   offline generate (a token may differ only under a top-2 margin below
   the logits' error); a reused slot bitwise to a fresh one; sampled
   streams bitwise on 16 and 4 slots; n-gram speculation equal with fewer
   target forwards; a prefix-cache hit bitwise to the miss.  The trace
   again at bf16 compute, timed, its checks reported;
   Then obs_serving: the trace's first 16 requests with Config.obs
   "metrics": requests = completed = 16, the tokens counter = the tokens
   emitted, the obs tool's TTFT / ITL p50 in the log2 bucket of the
   phase's own;
17. mesh-parallel serving phase (parallel_serving, the main path of the
   mesh-parallel decoding slice): the init_tp_lm tree at the flagship's
   widths (V 32768, D 2048, depth 8, 16 heads of 128, MLP 4x; seed
   weights, float32, TF32 off) served by Server.sharded as 2
   tensor-parallel replicas of 4 rank-major ranks, 8 slots x 2048 tokens
   each, the sublayers' allreduces on backend "pallas" under chunk_bytes
   512 KiB: a burst at 8 live slots times the decode step (one CUDA graph;
   median, min, max of 24; its bound; the ring rows' launches and device
   ms a step; 1 host sync a step and 1 a prefill), then lm_serving's trace
   under the wall clock (rows 11 and 8) and its first 8 requests with
   pallas_bidirectional (rows 12 and 7): tokens/s, TTFT and ITL p50 / p99,
   peak memory.  Checks: the TP logits against the dense oracle
   (models.oracle) within 1e-4 of the largest; every greedy stream against
   the oracle and against offline tp_generate (a token may differ only
   under a top-2 margin below that error); sampled streams bitwise on 4
   slots; speculation and a prefix-cache hit bitwise to the plain
   streams; both replicas served, one plan row each; every ring row
   launched bitwise to the plain ring; pp_generate over 4 stages (8 rows,
   prompt 128, 64 steps) against the oracle; generate_parallel of the
   moe_ep model at float32 (dcn 2 x ici 2) against each row alone with all
   experts local, and of the flagship with Ulysses attention over 4 ranks
   against its single-device generate; beam_search_parallel with one beam
   equal to greedy; then the examples parallel_serving (8 ranks on the
   ring) and moe_generate (dcn 2 x ici 2, 150 steps) to their JAX
   assertions;
18. tree verbs phase: collectives_bench.py's 64-leaf float32 / bfloat16
   tree at 1 and 16 MiB, allreduce_in_axis and reduce_scatter_in_axis
   across the NCCL world of one and the rank-major fused reduce-scatter of
   4 ranks on "pallas", per leaf (64 launches) and fused (2), bitwise
   equal, timed;
19. bus-bandwidth phase: the allreduce (rows 11 / 12 at 64 KiB-16 MiB,
   8 / 7 at 64 MiB a rank, and the stock route) and the allgather (rows
   14 / 10, stock) of 4 ranks rank-major, ms, algbw and busbw
   (collectives_bench.py's formulas), each against the plain ring; the
   hops are device copies on one card;
20. two-level phase (hier_dp, the main path of the two-level slice):
   ResNet-50 of phase 9 with its 4 ranks as a dcn 2 x ici 2 grid,
   backend "hierarchical", int8 error feedback, the ring per node;
21. parameter-server phase (downpour_ps, the main path of the
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
22. examples phase: the port's mnist_sequential, mnist_allreduce,
   cifar_resnet20 (ZeRO 0 and 3) and mnist_async_allreduce (4 buckets in
   the world of one; overlapped, 4 ranks rank-major on the ring), then
   mnist_downpour, mnist_easgd, alexnet_downpour (their defaults) and
   checkpoint_resume in-process on the card, each to its bar (MNIST >
   0.9, CIFAR > 0.85, AlexNet > 2 / 10, the resumed run's final loss
   below its loss at the crash);
23. prints the kernels' summary line (each kernel's launches summed over
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

# The sequence-parallel slice (longcontext_sp): the flagship's widths with
# 16 kv heads (JAX's sequence-parallel impls refuse GQA), RoPE, bf16
# compute, no window (long context is the point), one sequence of 8192
# tokens as SP_N ranks x 2048 rank-major on the one card: 8192 tokens a
# step, as in stage B'.
SP_N, SP_T, SP_BATCH = 4, 8192, 1
SP_LM = dict(LM, num_kv_heads=LM["num_heads"], window=None, max_len=SP_T)
# The residual kernel's shard pairs (q_offset, kv_offset) at [1, 2048, 16,
# 128]: a kv shard behind the q shard (every key valid; the kernel row's
# timing), the diagonal, and one ahead (every key masked).
SP_PAIRS = ((2048, 0), (2048, 2048), (0, 2048))
SP_TIMED = {"ring_flash": TIMED_STEPS, "ulysses_flash": 3}
SP_PATH_KERNELS = {
    "ring_flash": ("flash_fwd_residual", "flash_bwd_dq", "flash_bwd_dkv",
                   "xent_fwd", "xent_bwd_dx", "xent_bwd_dw"),
    "ulysses_flash": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                      "xent_fwd", "xent_bwd_dx", "xent_bwd_dw"),
}
# The example on the card, rank-major on 4 ranks, to the JAX bar (main
# raises below it).
SP_EXAMPLES = (("--devices", "4", "--attn", "ring_flash"),
               ("--devices", "4", "--attn", "ulysses"))
SP_STEP_PARTS = (("flash residual (ring forward)",
                  r"flash_fwd_kernel<\d+, true>"),) + LM_STEP_PARTS

# The expert-parallel slice (moe_ep): the flagship with its MLP an expert
# layer over ici (2 experts a rank, GShard top-2, capacity factor 2.0),
# rank-major on a dcn 2 x ici 2 grid, one row of 2048 tokens a rank (8192
# tokens a step, as stage B'): 4 global experts, replicated over dcn.  The
# loss is stage B''s fused loss plus 1e-2 times the layers' load-balance
# losses (their sum, the mean over the ranks).
EP_GRID = (2, 2)
EP_LM = dict(LM, moe_axis="ici", moe_experts_per_device=2, moe_k=2,
             moe_capacity_factor=2.0)
EP_AUX = 1e-2
# The layer alone at the flagship's shapes, float32: (k, capacity factor).
EP_LAYER_CASES = ((1, 2.0), (1, 0.5), (2, 2.0), (2, 0.5))
EP_PATH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                   "xent_bwd_dx", "xent_bwd_dw")
EP_EXAMPLE = ("--devices", "4", "--dcn", "2", "--top-k", "2")
# The step by part: the port's kernels, then the experts' float32 products
# (cuBLAS SIMT / f32 kernels; the bf16 projections are the "matmuls"
# part), the dispatch and the combine (index_add / index_select, the
# top-k sort, the cumulative count), the concatenations (the all-to-alls'
# stacks, RoPE's halves) and the rest.
EP_STEP_PARTS = LM_STEP_PARTS[:2] + (
    ("expert products (f32)", r"sgemm|f32f32|simt|gemmSN|gemv"),
    ("dispatch and combine", r"index|scatter|gather|[Ss]ort|scan|cumsum"),
    ("concatenations (all-to-all, RoPE)", r"CatArray|cat_"),
) + LM_STEP_PARTS[2:]

# The tensor- and pipeline-parallel slice (megatron_3d): a stack of
# Megatron blocks (parallel.tensor.tp_transformer_block) at the flagship's
# widths (D 2048, 16 heads of 128, F 8192; causal, window 1024, flash
# attention, float32), rank-major on pp 2 x dp 2 x tp 2 (8 ranks on the
# card): GPipe over pp with 4 blocks a stage, M 4 microbatches of 1 x 2048
# tokens a dp group (16,384 tokens a step), the f / g and dp allreduces on
# backend "pallas", the JAX example's regression loss, SGD lr 2e-3.
MG_SHAPE = {"pp": 2, "dp": 2, "tp": 2}
MG = dict(blocks=8, embed=LM["embed"], heads=LM["num_heads"],
          ffn=4 * LM["embed"], window=LM["window"], microbatches=4,
          batch=1, seq=SEQ)
MG_LR = 2e-3  # stage B''s 0.02 overshoots this loss at D 2048 (it rose)
# The checked steps against the oracle.  JAX's outputs tolerance (3e-4 /
# 3e-5, tests/test_pipeline.py:446-447) was set at D 8-32; at D 2048 after
# 8 residual blocks the absolute error of outputs near 0 nears its atol.
# So the atol and the loss limit here sit between the float32 steps'
# largest reading and the smallest reading of a control, the same step
# with TF32 products (the phase's ``control``), at the geometric mean of
# the two (PERF.md: float32 2.68e-5 and 4.64e-8, the control 8.71e-3
# and 2.12e-5, on an H100 80GB HBM3 at 700 W).  JAX's atol is reported
# beside them.  The gradients' limit lies between the float32 steps'
# 2.29e-6 and the control's 1.06e-3 as it is.
MG_JAX_ATOL = 3e-5
MG_OUT_TOL = dict(rtol=3e-4, atol=4.8e-4)
MG_LOSS_RTOL = 9.9e-7  # the loss's relative difference from the oracle's
MG_GRAD_RTOL = 1e-4  # every weight's gradient, rel. L2, against the oracle
MG_WORLD_BLOCKS = 2  # the world of one's stack (all 16 heads on one rank)
MG_PATH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
MG_EXAMPLES = (("--devices", "8", "--dp", "2"),
               ("--devices", "8", "--dp", "2", "--schedule", "interleaved"))
# The step by part: the port's kernels, cuBLAS's products, the copies and
# concatenations (the stage shifts, the layouts of the dp groups), the
# rest; the ranges of the f / g allreduces, the dp mean and the shifts
# (record_function) beside them.
MG_STEP_PARTS = (
    ("flash kernels", r"flash_\w*kernel"),
    ("ring rows", r"ring_direct|ring_\w*kernel"),
    ("products (cuBLAS)", r"nvjet|gemm|xmma|cutlass|cublas"),
    ("copies and concatenations", r"copy|Copy|Memcpy|CatArray|cat_"),
    ("reductions", r"reduce"),
    ("elementwise", r"elementwise|vectorized"),
)
MG_RANGES = ("tp/allreduce", "dp/mean", "pp/shift")

# The serving slice (lm_serving): the flagship at full width (LM, seed
# weights, float32, TF32 off) served by one ReplicaEngine of SERVE_SLOTS
# slots of LM["max_len"] tokens (float32 pool cache 8 x 2 x 16 x 2048 x 4 x
# 128 x 4 B = 1.07 GB), a trace of SERVE_REQUESTS requests from SEED:
# prompts SERVE_PROMPT tokens, SERVE_MAX_NEW new tokens, SERVE_SAMPLED of
# them sampled at SERVE_SAMPLING with their own seeds, Poisson arrivals at
# load SERVE_LOAD (benchmarks/serving_bench.py :235: mean gap = mean
# max_new / (load x slots) decode steps, a step's seconds measured first).
SERVE_SLOTS = 16
SERVE_REQUESTS = 48
SERVE_SAMPLED = 16
SERVE_PROMPT = (128, 1024)
SERVE_MAX_NEW = (32, 256)
SERVE_SAMPLING = dict(temperature=0.8, top_k=40, top_p=0.9)
SERVE_LOAD = 1.0
SERVE_LOGIT_RTOL = 1e-4  # (a): max |err| <= this x max |ref|, float32
SERVE_CHECKED = 8  # greedy requests of check (a)
SERVE_BURST_STEPS = 24  # timed decode steps at 16 live slots
SERVE_SPEC_K = 4
# (f): requests sharing a prefix of PREFIX tokens, TAIL tokens each after
# it, PREFIX_BLOCK tokens a prefix-cache block.
SERVE_PREFIX, SERVE_TAIL, SERVE_PREFIX_REQS, SERVE_PREFIX_BLOCK = \
    512, 64, 4, 128
SERVE_REUSE_STEPS = 32  # (c): decode steps on the reused and the fresh row

# The mesh-parallel serving slice (parallel_serving): the init_tp_lm layout
# at the flagship's widths (V 32768, D 2048, depth 8, 16 heads of 128, MLP
# 4x; seed weights, float32, TF32 off) served by Server.sharded: PSV_REPLICAS
# tensor-parallel replicas of PSV_TP rank-major ranks, PSV_SLOTS slots of
# LM["max_len"] tokens each (16 slots in all, lm_serving's count), the
# sublayers' allreduces on backend "pallas", on lm_serving's trace.
# chunk_bytes PSV_CHUNK_BYTES maps a decode step's sums (8 x 2048 float32 a
# rank) onto the resident rows 11 / 12 and a prefill above 256 tokens onto
# the chunked rows 8 / 7 (7 above 512 tokens, pallas_bidirectional).
PSV_TP, PSV_REPLICAS, PSV_SLOTS = 4, 2, 8
PSV_CHUNK_BYTES = 512 << 10
PSV_BIDIR_REQUESTS = 8  # the trace's first requests, bidirectional ring
PSV_SPEC_REQUESTS = 8   # the trace's first requests, with speculation
PSV_PP = dict(stages=4, batch=8, prompt=128, steps=64)  # (b)
PSV_GP = dict(batch=4, prompt=128, steps=32)  # (c): MoE and Ulysses
PSV_PATH_KERNELS = ("ring_allreduce", "ring_allreduce_chunked",
                   "ring_allreduce_bidir", "ring_allreduce_bidir_chunked")
PSV_SAMPLED_CHECKED = 8  # sampled requests decoded again on 4 slots
# The slice's examples in-process on the card, to JAX's assertions.
PSV_EXAMPLES = (("parallel_serving", ("--devices", "8", "--backend",
                                     "pallas")),
               ("moe_generate", ("--devices", "4", "--dcn", "2")))

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
    # Row 1's residual epilogue (the same pallas_call with
    # return_residuals=True): a second launcher of flash_fwd.cu.
    "flash_fwd_residual": ("torchmpi_tpu_torch/ops/csrc/flash_fwd.cu",
                           "torchmpi_tpu/ops/flash.py:337"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's seconds so far
    (``elapsed_s``), so the lines' differences time the phases."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - _T0)
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
            flags = re.findall(r"ELb([01])", m.group(1))
            fwd = "flash_fwd_kernel" in m.group(1)
            res = (" residual" if fwd and flags[:1] == ["1"] else "") + (
                " bf16" if flags[-1:] == ["1"] and (len(flags) == 2
                                                   or not fwd) else "")
            key = (f"D{d.group(1)}{res}" if d else
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
    path = [n for n in launches if n != "flash_fwd_residual"
            and (loss == "fused" or n.startswith("flash"))]
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


# restart_zero: zero_dp's ZeRO-1 flagship (RING_N ranks rank-major, Adam
# ZERO_LR, backend "pallas", the default chunk_bytes) as RZ_STEPS steps of
# restart.run_with_restarts, a checkpoint every RZ_SAVE_EVERY steps under
# ckpt_redundancy "buddy" and ckpt_keep RZ_KEEP, under watchdog "break" at
# RZ_WD_DEADLINE_S and a plan of the port's chaos tool (RZ_RULES: a stall
# at the staged gather of step RZ_STALL_STEP's loss reduction, then a silent
# rot at the first checkpoint read, the recovery's).  The disk must hold
# RZ_KEEP + 1 steps with their mirrors (the newest is written before the
# oldest is pruned); (a)'s files are gone before (b)'s sharded save.
RZ_STEPS, RZ_SAVE_EVERY, RZ_KEEP = 6, 2, 2
# The flagship's widths at depth 2: guard_dp and hotstate_zero; at depth 1:
# restart_zero and elastic_zero (the saves' disk writes and digests are
# most of their seconds; depth 8, then 2, then 1 kept the script inside
# its limit as phases were added).
LM_D2 = dict(LM, depth=2)
LM_D1 = dict(LM, depth=1)
RZ_STALL_STEP = 5
RZ_RECOVERED_STEP = 4
RZ_WD_DEADLINE_S = 1.0
RZ_RULES = (f"host_staged.gather:stall:1:1:0:{RZ_STALL_STEP}",
            "ckpt.read:corrupt_silent:1:1")


class _Clock:
    """Seconds spent in wrapped module functions, by the current label."""

    def __init__(self):
        self.label = ""
        self.seconds = {}
        self._undo = []

    def patch(self, mod, name, fn):
        """Replace ``mod.name`` by ``fn`` until :meth:`restore`; returns
        the original."""
        orig = getattr(mod, name)
        setattr(mod, name, fn)
        self._undo.append((mod, name, orig))
        return orig

    def wrap(self, mod, name, key):
        """Time every call of ``mod.name`` under ``key``."""
        orig = getattr(mod, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                d = self.seconds.setdefault(self.label, {})
                d[key] = d.get(key, 0.0) + time.perf_counter() - t0

        return self.patch(mod, name, timed)

    def restore(self):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo = []


def zero1_step(torch, mpi, model, tok, members, views, flats, opt, tx):
    """restart_zero's and elastic_zero's ZeRO-1 Adam step, with no host
    sync: member ``m`` (row ``k`` of the stack) the gradients of sequence
    ``m`` into row ``k`` of ``views``, zero.update_rank_major under
    backend "pallas" (rows 9 and 10), the new parameters loaded.  Returns
    (the new Adam state, the members' losses in float32)."""
    params = list(model.parameters())
    losses = []
    for k, m in enumerate(members):
        model.zero_grad(set_to_none=True)
        loss = fused_lm_loss(torch, mpi, model, tok[m:m + 1])
        loss.backward()
        losses.append(loss.detach())
        for v, p in zip(views, params):
            v[k].copy_(p.grad)
    model.zero_grad(set_to_none=True)
    new, opt = mpi.parallel.zero.update_rank_major(params, flats, opt, tx,
                                                   backend="pallas")
    with torch.no_grad():
        for p, v in zip(params, new):
            p.copy_(v)
    return opt, torch.stack(losses).float()


def restart_zero_phase(torch, mpi, ops, dev):
    """The checkpoint slice's main path on zero_dp's ZeRO-1 flagship.  A
    step: rank r's gradients of sequence r into the [4, shard] stack,
    zero.update_rank_major under backend "pallas" (rows 9 and 10, the
    fused loss rows 4-6 and flash rows 1-3 in the ranks' steps), then the
    4 losses read to the host and reduced by the staged rank-major
    allreduce (backend "host").  (a) RZ_STEPS steps through
    restart.run_with_restarts (RZ_RULES, watchdog "break", buddy
    checkpoints), the kernel counters set to 0 just before and read just
    after, then the same steps plainly (no saves, faults or watchdog) from
    the same start, to which the recovered run is held bitwise; (b) the
    final state through save_sharded / restore_sharded, the moments as
    RING_N rank-major shards.  Every check raises."""
    import shutil
    import tempfile

    import numpy as np

    from torchmpi_tpu_torch import obs, optim
    from torchmpi_tpu_torch.faults import integrity
    from torchmpi_tpu_torch.utils import checkpoint, durable, restart

    ring = ops["ring"]
    zero, fusion = mpi.parallel.zero, mpi.fusion
    n = RING_N
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    model = mpi.models.TransformerLM(**LM_D1, attn_impl="flash",
                                     dtype=torch.bfloat16, device=dev,
                                     generator=g)
    tok = torch.randint(0, LM["vocab"], (BATCH, SEQ), generator=g,
                        device=dev)
    params = list(model.parameters())
    spec = zero.flat_spec(params, n_shards=n)
    flats, views = fusion.rank_major_buffers(spec, n, device=dev)
    tx = mpi.optim.adam(ZERO_LR)
    state0 = zero.init_rank_major(params, tx, n)
    p_init = [p.detach().clone() for p in params]
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    moment_bytes = 2 * state0.mu.numel() * state0.mu.element_size()

    @torch.no_grad()
    def load(new):
        for p, v in zip(params, new):
            p.copy_(v)

    def core(opt):
        return zero1_step(torch, mpi, model, tok, range(n), views, flats,
                          opt, tx)

    def loss_read(losses):
        """The losses to the host, then the staged rank-major mean."""
        red = mpi.allreduce_rank_major(losses.cpu().reshape(n, 1),
                                       op="mean", backend="host")
        return float(red[0, 0])

    def make_step(loss_by_step):
        def step_fn(state, i):
            if state["params"] is not params:  # a restored state
                load(state["params"])
            o = state["opt"]
            opt, losses = core(optim.AdamState(int(o.count), o.mu, o.nu))
            loss_by_step[i] = loss_read(losses)
            return {"params": params, "opt": opt}
        return step_fn

    def init_fn():
        load(p_init)
        return {"params": params, "opt": state0}

    work = tempfile.mkdtemp(prefix="restart_zero_")
    ckpt_dir = os.path.join(work, "ckpt")
    save_est = param_bytes + moment_bytes
    disk = shutil.disk_usage(work)
    need = (RZ_KEEP + 1) * 2 * save_est
    out = {"phase": "restart_zero", "ranks": n,
           "optimizer": f"adam({ZERO_LR})", "steps": RZ_STEPS,
           "save_every": RZ_SAVE_EVERY, "keep": RZ_KEEP, "rules": RZ_RULES,
           "watchdog_deadline_s": RZ_WD_DEADLINE_S,
           "param_bytes": param_bytes, "moment_bytes": moment_bytes,
           "disk_usage": {"dir": work, "total": disk.total,
                          "used": disk.used, "free": disk.free},
           "disk_needed_bytes": need}
    print(json.dumps({"restart_zero_disk": out["disk_usage"],
                      "needed_bytes": need}), flush=True)
    check(disk.free >= need, f"restart_zero: the disk under {work} holds "
          f"{disk.free} free bytes, {need} needed for {RZ_KEEP + 1} steps "
          f"of {save_est} bytes with their mirrors")
    clock = _Clock()
    saves, hangs = [], []
    try:
        # (a) the restart loop under the plan.
        plan = _chaos_plan(os.path.join(work, "plan.json"), RZ_RULES)
        mpi.set_config(ckpt_redundancy="buddy", ckpt_keep=RZ_KEEP,
                       faults=plan, watchdog="break",
                       watchdog_deadline_s=RZ_WD_DEADLINE_S,
                       watchdog_poll_s=0.02, obs="metrics",
                       obs_dir=os.path.join(work, "obs"))
        obs.reset()
        save = checkpoint.save

        def timed_save(d, tree, *, step):
            clock.label = f"save {step}"
            t0 = time.perf_counter()
            path = save(d, tree, step=step)
            saves.append({"step": step, "seconds": time.perf_counter() - t0,
                          "npz_bytes": os.path.getsize(path)})
            clock.label = ""
            return path

        clock.patch(checkpoint, "save", timed_save)
        clock.wrap(restart, "recover", "total_s")
        recover = restart.recover

        def timed_recover(*a, **k):
            clock.label = "recover"
            try:
                return recover(*a, **k)
            finally:
                clock.label = ""

        clock.patch(restart, "recover", timed_recover)
        clock.wrap(checkpoint, "_read_npz_bytes", "read_s")
        clock.wrap(integrity, "digest_bytes", "digest_s")
        clock.wrap(checkpoint, "_write_atomic", "write_s")
        clock.wrap(checkpoint, "_snapshot", "snapshot_s")
        clock.wrap(checkpoint, "_npz_buffer", "serialize_s")
        losses_rz = {}
        torch.cuda.synchronize()
        for mod in ops.values():
            mod.reset_launches()
        t0 = time.perf_counter()
        final, info = restart.run_with_restarts(
            init_fn, make_step(losses_rz), steps=RZ_STEPS,
            directory=ckpt_dir, save_every=RZ_SAVE_EVERY,
            on_peer_timeout=lambda r, e: hangs.append(e))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {nm: c for mod in ops.values()
                    for nm, c in mod.LAUNCHES.items()}
        clock.restore()
        reg = obs.registry()
        counters = {k: reg.counter_total(f"tm_ckpt_{k}_total") for k in
                    ("saved", "verified", "verify_failed", "repaired",
                     "pruned", "walkback")}
        from torchmpi_tpu_torch import watchdog

        hang_types = [type(e).__name__ for e in hangs]
        hang_s = [getattr(e, "elapsed_s", None) for e in hangs]
        broken = all(isinstance(e, watchdog.CollectiveHangError)
                     for e in hangs)
        del hangs
        mpi.set_config(faults="off", watchdog="off", obs="off",
                       ckpt_redundancy="off", ckpt_keep=0)
        obs.deactivate()
        obs.reset()
        left = sorted(f for f in os.listdir(ckpt_dir)
                      if f.startswith("ckpt_"))
        left_buddy = sorted(os.listdir(durable.buddy_dir(ckpt_dir, 0)))
        want_left = sorted(f"ckpt_{s}_p0.{e}" for s in (4, 6)
                           for e in ("npz", "json"))
        rz_params = [p.detach().clone() for p in params]
        rz_mu, rz_nu = final["opt"].mu, final["opt"].nu
        del final
        # The same steps plainly, from the same start.
        losses_plain = {}
        plain_step = make_step(losses_plain)
        st = init_fn()
        for i in range(RZ_STEPS):
            st = plain_step(st, i)
        torch.cuda.synchronize()
        bitwise = {"params": all(torch.equal(a, b)
                                 for a, b in zip(rz_params, params)),
                   "mu": torch.equal(rz_mu, st["opt"].mu),
                   "nu": torch.equal(rz_nu, st["opt"].nu),
                   "count": int(st["opt"].count) == RZ_STEPS,
                   "losses": [losses_rz[i] for i in range(RZ_STEPS)]
                   == [losses_plain[i] for i in range(RZ_STEPS)]}
        del rz_params, rz_mu, rz_nu
        rec = clock.seconds.get("recover", {})
        out.update(
            info=info, run_seconds=run_s, hang_types=hang_types,
            hang_elapsed_s=hang_s, losses=[losses_rz[i]
                                           for i in range(RZ_STEPS)],
            saves=[dict(sv, seconds_by_part=clock.seconds.get(
                f"save {sv['step']}", {}), written_bytes=2 * sv[
                    "npz_bytes"], gb_per_s=2 * sv["npz_bytes"]
                / sv["seconds"] / 1e9) for sv in saves],
            recovery=dict(rec, read_gb_per_s=(
                2 * saves[-1]["npz_bytes"] / rec["read_s"] / 1e9
                if rec.get("read_s") else None)),
            ckpt_counters=counters, files_left=left,
            buddy_files_left=left_buddy, bitwise_vs_plain=bitwise,
            launches=launches)
        shutil.rmtree(ckpt_dir, ignore_errors=True)

        # (b) the final state sharded (ckpt_redundancy "off"): the moments
        # as RING_N rank-major shards, the parameters as one full shard
        # each.
        Sharded = checkpoint.Sharded
        opt = st["opt"]
        tree = {"params": params, "opt": optim.AdamState(
            int(opt.count), Sharded.rank_major(opt.mu),
            Sharded.rank_major(opt.nu))}
        sh_dir = os.path.join(work, "sharded")
        t0 = time.perf_counter()
        checkpoint.save_sharded(sh_dir, tree, step=RZ_STEPS)
        sh_save_s = time.perf_counter() - t0
        npz = os.path.join(sh_dir, f"shckpt_{RZ_STEPS}_p0.npz")
        sh_bytes = os.path.getsize(npz)
        tmpl = {"params": [torch.empty_like(p) for p in params],
                "opt": optim.AdamState(0, tree["opt"].mu.template(),
                                       tree["opt"].nu.template())}
        t0 = time.perf_counter()
        got = checkpoint.restore_sharded(sh_dir, tmpl)
        torch.cuda.synchronize()
        sh_restore_s = time.perf_counter() - t0
        sh_bitwise = (torch.equal(got["opt"].mu.stack(), opt.mu)
                      and torch.equal(got["opt"].nu.stack(), opt.nu)
                      and all(torch.equal(a, b)
                              for a, b in zip(got["params"], params))
                      and int(got["opt"].count) == RZ_STEPS)
        del got, tmpl
        half = Sharded.rank_major(torch.empty(
            2, 2 * spec.shard, device="meta")).template(device=dev)
        raised = None
        try:
            checkpoint.restore_sharded(sh_dir, {
                "params": [torch.empty_like(p) for p in params],
                "opt": optim.AdamState(0, half, half)})
        except ValueError as e:
            raised = str(e)
        with open(npz[:-4] + ".json") as f:
            meta = json.load(f)["leaves"]
        mu_meta = meta["opt/.mu"]
        small = min(range(len(params)), key=lambda k: params[k].numel())
        with np.load(npz) as data:
            names = sorted(data.files)
            small_arr = data[f"params/{small}//0"]
            mu1 = data["opt/.mu//1"]
            mu1_equal = mu1.tobytes() == opt.mu[1].cpu().numpy().tobytes()
            del mu1
        shard = spec.shard
        layout = {
            "mu_record": mu_meta["shape"] == [n * shard]
            and mu_meta["dtype"] == "float32" and mu_meta["shards"] == [
                {"extents": [[r * shard, (r + 1) * shard]],
                 "name": f"opt/.mu//{r}"} for r in range(n)],
            "mu_arrays": sum(nm.startswith("opt/.mu//") for nm in names) == n
            and mu1_equal,
            "param_record": meta[f"params/{small}"] == {
                "shape": list(params[small].shape),
                "dtype": str(params[small].dtype).split(".")[-1],
                "shards": [{"extents": [[0, s] for s in params[small].shape],
                            "name": f"params/{small}//0"}]},
            "param_bits": small_arr.tobytes() == params[small].detach()
            .contiguous().view(torch.uint8).cpu().numpy().tobytes()}
        out.update(sharded={
            "npz_bytes": sh_bytes, "save_s": sh_save_s,
            "save_gb_per_s": sh_bytes / sh_save_s / 1e9,
            "restore_s": sh_restore_s,
            "restore_gb_per_s": sh_bytes / sh_restore_s / 1e9,
            "bitwise": sh_bitwise, "two_shard_template_raised": raised,
            "layout_as_jax": layout, "n_arrays": len(names)})
        del st, opt, tree
        # Host syncs: the step without the loss read (every kernel of the
        # path), then the loss read alone.
        syncs_core = count_host_syncs(torch, lambda: core(state0))
        _, losses = core(state0)
        syncs_read = count_host_syncs(torch, lambda: loss_read(losses))
        out.update(host_syncs_per_step={"outside_loss_read": syncs_core,
                                        "loss_read": syncs_read})
        del losses
    finally:
        clock.restore()
        mpi.set_config(faults="off", watchdog="off", obs="off",
                       ckpt_redundancy="off", ckpt_keep=0)
        shutil.rmtree(work, ignore_errors=True)
    emit(out)
    check(info == {"restarts": 1, "restarts_used": 1,
                   "steps_run": RZ_STEPS + RZ_STALL_STEP - RZ_RECOVERED_STEP,
                   "recovered_step": RZ_RECOVERED_STEP},
          f"restart_zero (a): info {info}")
    check(hang_types == ["CollectiveHangError"] and broken,
          f"restart_zero (a): on_peer_timeout saw {hang_types}")
    check(counters["verify_failed"] == 1 and counters["repaired"] == 1,
          f"restart_zero (a): ckpt counters {counters}")
    check(all(bitwise.values()), f"restart_zero (a): the recovered run "
          f"against 6 plain steps: {bitwise}")
    check(left == want_left and left_buddy == want_left,
          f"restart_zero (a): retention left {left} / {left_buddy}")
    check(out["host_syncs_per_step"]["outside_loss_read"] == 0,
          f"restart_zero (a): host syncs {out['host_syncs_per_step']}")
    sh = out["sharded"]
    check(sh["bitwise"], "restart_zero (b): the sharded restore differs")
    check(sh["two_shard_template_raised"] is not None
          and "opt/.mu" in sh["two_shard_template_raised"],
          f"restart_zero (b): 2-shard template: {raised}")
    check(all(sh["layout_as_jax"].values()), f"restart_zero (b): the files' "
          f"names or extents are not the JAX package's: {sh['layout_as_jax']}")
    for nm in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
               "xent_bwd_dx", "xent_bwd_dw", "ring_reduce_scatter_chunked",
               "ring_all_gather_chunked"):
        check(launches.get(nm, 0) > 0,
              f"restart_zero: kernel {nm} never launched")
    return launches


class ZeroGang:
    """restart_zero's ZeRO-1 Adam flagship (at ``lm``'s depth: 1 in
    elastic_zero, 2 in hotstate_zero) as an elastic gang of rank-major rows:
    the model, the batch and the initial parameters, made once from
    SEED + 6; :meth:`build_for` is
    ``elastic.run_elastic``'s ``build`` for one run, recording into
    ``record`` (losses by step, step ms by n, re-partition seconds).  The
    state the checkpoints and the hot tier hold is topology portable: the
    parameters and the full Adam moments; a view's build re-derives the
    [n, shard] moments (the re-partition)."""

    def __init__(self, torch, mpi, ring, dev, log, what, lm):
        self.torch, self.mpi, self.ring, self.dev = torch, mpi, ring, dev
        self.log, self.what, self.lm = log, what, lm
        g = torch.Generator(device=dev).manual_seed(SEED + 6)
        self.model = mpi.models.TransformerLM(
            **lm, attn_impl="flash", dtype=torch.bfloat16, device=dev,
            generator=g)
        self.tok = torch.randint(0, LM["vocab"], (BATCH, SEQ), generator=g,
                                 device=dev)
        self.params = list(self.model.parameters())
        self.p_init = [p.detach().clone() for p in self.params]
        self.total = sum(p.numel() for p in self.params)
        self.tx = mpi.optim.adam(ZERO_LR)
        self.param_bytes = sum(p.numel() * p.element_size()
                               for p in self.params)

    def load(self, new):
        with self.torch.no_grad():
            for p, v in zip(self.params, new):
                p.copy_(v)

    def snapshot(self, state):
        """A copy of ``state`` on the card: parameters, count, moments."""
        o = state["opt"]
        return {"params": [p.detach().clone() for p in state["params"]],
                "count": int(o.count), "mu": o.mu.clone(),
                "nu": o.nu.clone()}

    def clean_run(self, state, step, members, steps, record,
                  rows_by="member"):
        """A clean run from ``state`` (the true or a restored state) at
        ``step`` to ``steps``: the view's program (:meth:`build_for`)
        stepped as ``run_elastic`` would after restoring it, with no
        checkpoint, fault or hot tier.  Returns the final state's
        :meth:`snapshot`."""
        from torchmpi_tpu_torch import optim
        from torchmpi_tpu_torch.faults.membership import MembershipView

        comm = self.mpi.runtime.resize_world(list(members))
        _, step_fn = self.build_for(record, rows_by=rows_by)(
            comm, MembershipView(epoch=0, members=tuple(members), step=step))
        o = state["opt"]
        st = {"params": state["params"],
              "opt": optim.AdamState(int(o.count), o.mu, o.nu)}
        for i in range(step, steps):
            st = step_fn(st, i)
        return self.snapshot(st)

    def build_for(self, record, *, check_n=None, after_step=None,
                  rows_by="member"):
        """``check_n``: at that member count the ring calls are compared
        with the plain ring (``log.check``) and the first step's update is
        held to a replicated Adam update (``record["rep"]``, its launches
        in ``record["rep_launches"]``, its seconds left out of the step's).
        ``after_step(n, i, state)`` runs after step ``i``'s losses are read.
        ``rows_by`` "member": member m computes sequence m; "position": the
        k-th member of the view computes sequence k (a spare seated in a
        drained member's place)."""
        torch, mpi, dev, log = self.torch, self.mpi, self.dev, self.log
        from torchmpi_tpu_torch import optim

        ring, zero, fusion = self.ring, mpi.parallel.zero, mpi.fusion
        params, total, tx = self.params, self.total, self.tx

        def build(comm, view):
            members = view.members
            n = len(members)
            check(comm.fixed_size() == n
                  and mpi.runtime.world_rows() == tuple(members),
                  f"{self.what}: world {comm} for view {view}")
            seqs = members if rows_by == "member" else range(n)
            t0 = time.perf_counter()
            spec = zero.flat_spec(params, n_shards=n)
            check(len(spec.groups) == 1, f"{self.what}: one dtype group")
            flats, views = fusion.rank_major_buffers(spec, n, device=dev)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0

            def shards(full):
                return torch.nn.functional.pad(
                    full, (0, n * spec.shard - full.numel())).reshape(
                        n, spec.shard)

            def init_fn():
                self.load(self.p_init)
                z = torch.zeros(total, dtype=spec.dtype, device=dev)
                return {"params": params,
                        "opt": optim.AdamState(0, z, z.clone())}

            first = [True]
            # The last step's [n, shard] moments beside the full-length
            # views the state carries: the next step of the segment takes
            # them as they are; a restored state is re-partitioned.
            held = {"mu": None, "opt": None}

            def step_fn(state, i):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if state["params"] is not params:
                    self.load(state["params"])
                o = state["opt"]
                opt = (held["opt"] if o.mu is held["mu"] else
                       optim.AdamState(int(o.count), shards(o.mu),
                                       shards(o.nu)))
                if first[0]:
                    torch.cuda.synchronize()
                    record["repartition_s"].append(
                        {"n": n, "seconds": build_s + time.perf_counter()
                         - t0})
                log.label = f"n{n}"
                log.check = check_n == n
                p0 = (fusion.flatten_tree(params, spec).detach()
                      if first[0] and log.check else None)
                nopt, losses = zero1_step(torch, mpi, self.model, self.tok,
                                          seqs, views, flats, opt, tx)
                if p0 is not None:
                    # One ZeRO-1 update against a replicated Adam update
                    # from the same parameters, state and stack (zero_dp's
                    # check), its launches and its seconds set aside.
                    torch.cuda.synchronize()
                    t_check = time.perf_counter()
                    log.check = False
                    before = {nm: ring.LAUNCHES[nm] for nm in ring.LAUNCHES}
                    with torch.no_grad():
                        buf = flats[0].clone()
                        fusion.fused_allreduce_rank_major_(
                            [buf], backend="pallas", op="mean")
                        upd, _ = tx.update(buf[0], optim.AdamState(
                            opt.count, opt.mu.reshape(-1),
                            opt.nu.reshape(-1)))
                        d_zero = fusion.unflatten_tree(
                            fusion.flatten_tree(params, spec) - p0, spec)
                        d_rep = fusion.unflatten_tree(upd, spec)
                        rel = [float((a - b).norm()
                                     / b.norm().clamp_min(1e-30))
                               for a, b in zip(d_zero, d_rep)]
                    del buf, upd, d_zero, d_rep
                    record["rep"] = {"n": n, "step": i,
                                     "max_rel_l2": max(rel)}
                    record["rep_launches"] = {
                        nm: ring.LAUNCHES[nm] - before[nm]
                        for nm in ring.LAUNCHES
                        if ring.LAUNCHES[nm] != before[nm]}
                    torch.cuda.synchronize()
                    t0 += time.perf_counter() - t_check
                first[0] = False
                red = mpi.allreduce_rank_major(
                    losses.cpu().reshape(n, 1), op="mean", backend="host")
                record["losses"][i] = float(red[0, 0])
                torch.cuda.synchronize()
                record["step_ms"].setdefault(f"n{n}", []).append(
                    (time.perf_counter() - t0) * 1e3)
                held["opt"] = nopt
                held["mu"] = nopt.mu.reshape(-1)[:total]
                out = {"params": params, "opt": optim.AdamState(
                    nopt.count, held["mu"], nopt.nu.reshape(-1)[:total])}
                if after_step is not None:
                    after_step(n, i, out)
                return out

            return init_fn, step_fn

        return build


# elastic_zero: restart_zero's ZeRO-1 Adam flagship at depth 1 as an
# elastic gang of RING_N members (one rank-major row each) under
# ``faults/tool.py --shrink EZ_KILL`` (member 2 dies at step 5): the gang
# shrinks to 3, the moments re-partitioned over 3 rows, and member 2 admits
# itself back once step EZ_REJOIN_AFTER - 1 ran at n = 3.
EZ_STEPS, EZ_SAVE_EVERY = 8, 2
EZ_KILL = (2, 5, RING_N)  # member, step, members
EZ_RECOVERED_STEP = 4
EZ_REJOIN_AFTER = 6
# The ring rows a tapped call may launch, by verb (the chunked row under
# the default chunk_bytes, the resident one above it).
EZ_ROWS_BY_VERB = {
    "reduce_scatter": ("ring_reduce_scatter_chunked", "ring_reduce_scatter"),
    "all_gather": ("ring_all_gather_chunked", "ring_all_gather")}


def elastic_zero_phase(torch, mpi, ops, dev):
    """The elastic slice's main path: restart_zero's ZeRO-1 Adam step
    (zero.update_rank_major, backend "pallas": rows 9 and 10; the fused
    loss rows 4-6 and flash rows 1-3 in the members' steps) at depth 1,
    member m the row of sequence m, through ``elastic.run_elastic`` with
    ``Config.elastic`` "on" (ckpt_redundancy off), the kernel counters set
    to 0 just before and read just after.  The state the checkpoints hold
    is topology portable: the parameters and the full Adam moments; a
    view's build re-derives the [n, shard] moments (the re-partition).
    (a) ``--shrink 2:5:4``: member 2 dies at step 5; info shrinks 1,
    view (0, 1, 3), the moments over 3 rows; the n = 3 losses and the
    state at the rejoin boundary bitwise to a clean 3-member run stepped
    from the recovered step's checkpoint (``ZeroGang.clean_run``).  (b)
    Member 2's
    ``elastic.admit`` (a thread) once step EZ_REJOIN_AFTER - 1 ran at n = 3:
    the gang grows back to (0, 1, 2, 3) at the next boundary, the joiner's
    checkpoint file seeded through ``checkpoint.replicate_for`` (byte for
    byte the survivor's), and the steps after it bitwise to a clean
    4-member run from that boundary's checkpoint.  (c) Every row 9 / 10
    call at n = 3 bitwise to the plain ring (the selector's routes tapped)
    and launching the row it reports; one ZeRO-1 update at n = 3 against a
    replicated Adam update from the same state: rel. L2 <= ZERO_RTOL.
    The main run ends with the whole gang, which hands back init's world.
    Reports the save, recovery, reconcile and re-partition seconds and
    the step ms at n 4 and n 3.  Every check raises."""
    import shutil
    import tempfile
    import threading

    from torchmpi_tpu_torch import elastic, optim
    from torchmpi_tpu_torch.faults import membership
    from torchmpi_tpu_torch.faults import tool as ftool
    from torchmpi_tpu_torch.utils import checkpoint, restart

    ring = ops["ring"]
    log = TapLog()
    gang = ZeroGang(torch, mpi, ring, dev, log, "elastic_zero", LM_D1)
    params, total = gang.params, gang.total
    param_bytes = gang.param_bytes
    rows = ZERO_ROWS["chunked"]
    rec = {"losses": {}, "step_ms": {}, "repartition_s": [], "rep": None,
           "rep_launches": {}}
    rejoin_go = threading.Event()
    world0 = mpi.runtime.world_communicator()

    def rejoin_signal(n, i, _state):
        if n == EZ_KILL[2] - 1 and i + 1 == EZ_REJOIN_AFTER:
            rejoin_go.set()
            board = membership.Board(os.path.join(ckpt_dir, "membership"))
            t1 = time.monotonic()
            while EZ_KILL[0] not in board.join_requests():
                check(time.monotonic() - t1 < 60,
                      "elastic_zero (b): the join never landed")
                time.sleep(0.01)

    def build_for(record):
        if record is rec:
            return gang.build_for(record, check_n=EZ_KILL[2] - 1,
                                  after_step=rejoin_signal)
        return gang.build_for(record)

    work = tempfile.mkdtemp(prefix="elastic_zero_")
    ckpt_dir = os.path.join(work, "ckpt")
    save_est = param_bytes + 2 * total * 4
    disk = shutil.disk_usage(work)
    need = 9 * save_est
    out = {"phase": "elastic_zero", "members": RING_N,
           "depth": LM_D1["depth"], "optimizer": f"adam({ZERO_LR})",
           "steps": EZ_STEPS, "save_every": EZ_SAVE_EVERY,
           "shrink": "%d:%d:%d" % EZ_KILL,
           "rejoin_after_step": EZ_REJOIN_AFTER, "params": total,
           "save_bytes_est": save_est,
           "disk_usage": {"free": disk.free, "needed": need}}
    check(disk.free >= need, f"elastic_zero: {disk.free} bytes free under "
          f"{work}, {need} needed")
    clock = _Clock()
    joined = {}
    try:
        plan = os.path.join(work, "shrink.json")
        check(ftool.main(["gen", "--out", plan, "--seed", str(CHAOS_SEED),
                          "--shrink", "%d:%d:%d" % EZ_KILL]) == 0,
              "elastic_zero: chaos tool --shrink")
        mpi.set_config(elastic="on", faults=plan)
        for mod, name, key in ((checkpoint, "save", "save_s"),
                               (restart, "recover", "recover_s"),
                               (membership, "reconcile", "reconcile_s")):
            orig = getattr(mod, name)

            def timed(*a, _orig=orig, _key=key, **k):
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **k)
                finally:
                    clock.seconds.setdefault(_key, []).append(
                        time.perf_counter() - t0)

            clock.patch(mod, name, timed)

        def joiner():
            if not rejoin_go.wait(600):
                return
            try:
                view = elastic.admit(ckpt_dir, EZ_KILL[0], deadline_s=120)
                joined["view"] = view.to_json()
                checkpoint.replicate_for(ckpt_dir, view.step, [EZ_KILL[0]],
                                         src_proc=0)
                stem = os.path.join(ckpt_dir, f"ckpt_{view.step}_p")
                with open(stem + "0.npz", "rb") as a, \
                        open(stem + f"{EZ_KILL[0]}.npz", "rb") as b:
                    joined["seeded_equal"] = a.read() == b.read()
            except Exception as e:  # noqa: BLE001 — reported and checked
                joined["error"] = repr(e)

        th = threading.Thread(target=joiner, daemon=True)
        th.start()
        restore_taps = tap_rank_major_routes(torch, mpi, ring, log)
        torch.cuda.synchronize()
        for mod in ops.values():
            mod.reset_launches()
        t0 = time.perf_counter()
        try:
            final, info = elastic.run_elastic(
                build_for(rec), steps=EZ_STEPS, directory=ckpt_dir,
                save_every=EZ_SAVE_EVERY, members=range(RING_N),
                world_size=RING_N)
        finally:
            restore_taps()
            rejoin_go.set()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        th.join(180)
        launches = {nm: c for mod in ops.values()
                    for nm, c in mod.LAUNCHES.items()}
        for nm, c in rec["rep_launches"].items():
            launches[nm] -= c
        clock.restore()
        mpi.set_config(faults="off")
        seconds = {k: {"calls": len(v), "total": sum(v), "each": v}
                   for k, v in clock.seconds.items()}
        el_params = [p.detach().clone() for p in params]
        el_mu, el_nu = final["opt"].mu.clone(), final["opt"].nu.clone()
        del final
        r, b = EZ_RECOVERED_STEP, info["recovered_step"]
        n3 = [e for e in log if e["label"] == f"n{EZ_KILL[2] - 1}"]
        taps = {"calls": len(n3),
                "bitwise": all(e["bitwise"] for e in n3),
                "rows": sorted({tuple(e["rows"]) for e in n3}),
                "rows_as_reported": all(
                    len(e["rows"]) == 1 and e["rows"][0] in
                    EZ_ROWS_BY_VERB[e["verb"]] for e in n3),
                "all_gather_rows_equal": all(e.get("rows_equal", True)
                                             for e in n3),
                "elems_a_rank": sorted({e["elems"] for e in n3})}

        world_after = {"rows": mpi.runtime.world_rows(),
                       "init_world": mpi.runtime.world_communicator()
                       is world0}
        tmpl = {"params": [torch.empty_like(p) for p in params],
                "opt": optim.AdamState(0, torch.empty_like(el_mu),
                                       torch.empty_like(el_nu))}

        # (a) a clean 3-member run from the recovered step's checkpoint to
        # the rejoin boundary; its state against the boundary's checkpoint.
        survivors = [m for m in range(RING_N) if m != EZ_KILL[0]]
        clean3 = {"losses": {}, "step_ms": {}, "repartition_s": [],
                  "rep": None, "rep_launches": {}}
        st3 = gang.clean_run(checkpoint.restore(ckpt_dir, tmpl, step=r), r,
                             survivors, b, clean3)
        at_b = gang.snapshot(checkpoint.restore(ckpt_dir, tmpl, step=b))
        bit_a = {"losses": [rec["losses"][i] for i in range(r, b)]
                 == [clean3["losses"][i] for i in range(r, b)],
                 "params": all(torch.equal(x, y) for x, y in
                               zip(at_b["params"], st3["params"])),
                 "mu": torch.equal(at_b["mu"], st3["mu"]),
                 "nu": torch.equal(at_b["nu"], st3["nu"]),
                 "count": at_b["count"] == st3["count"]}
        del st3
        torch.cuda.empty_cache()

        # (b) a clean 4-member run from the boundary's checkpoint to the
        # end.
        clean4 = {"losses": {}, "step_ms": {}, "repartition_s": [],
                  "rep": None, "rep_launches": {}}
        st4 = gang.clean_run(
            {"params": at_b["params"], "opt": optim.AdamState(
                at_b["count"], at_b["mu"], at_b["nu"])},
            b, range(RING_N), EZ_STEPS, clean4)
        bit_b = {"losses": [rec["losses"][i] for i in range(b, EZ_STEPS)]
                 == [clean4["losses"][i] for i in range(b, EZ_STEPS)],
                 "params": all(torch.equal(x, y) for x, y in
                               zip(el_params, st4["params"])),
                 "mu": torch.equal(el_mu, st4["mu"]),
                 "nu": torch.equal(el_nu, st4["nu"])}
        del st4, at_b, tmpl, el_params, el_mu, el_nu
        mpi.runtime.restore_world()
        info_js = dict(info, view=info["view"].to_json())
        out.update(
            world_after=world_after,
            info=info_js, run_seconds=run_s, joined=joined,
            losses=[rec["losses"][i] for i in sorted(rec["losses"])],
            moments_rows={"n3": [EZ_KILL[2] - 1],
                          "repartitions": rec["repartition_s"]},
            seconds=seconds, step_ms=rec["step_ms"],
            median_step_ms={k: statistics.median(v)
                            for k, v in rec["step_ms"].items()},
            bitwise_shrink_vs_clean3=bit_a, bitwise_rejoin_vs_clean4=bit_b,
            n3_ring_calls=taps, replicated_at_n3=rec["rep"],
            replicated_tolerance=ZERO_RTOL, launches=launches,
            launches_on_16_byte_path={
                nm: {"all": ring.LAUNCHES[nm],
                     "vector": ring.VECTOR_LAUNCHES[nm]} for nm in rows})
    finally:
        clock.restore()
        rejoin_go.set()
        mpi.set_config(elastic="off", faults="off")
        shutil.rmtree(work, ignore_errors=True)
    emit(out)
    check(info["shrinks"] == 1 and info["rejoins"] == 1
          and info["reconciles"] == 2
          and info["recoveries"] == [0, EZ_RECOVERED_STEP, b]
          and info_js["view"]["members"] == list(range(RING_N)),
          f"elastic_zero: info {info_js}")
    check(b >= EZ_REJOIN_AFTER and rec["step_ms"].get(
        f"n{EZ_KILL[2] - 1}"), f"elastic_zero: no step ran at n = 3 "
          f"before the rejoin at {b}")
    check([x["n"] for x in rec["repartition_s"]]
          == [RING_N, RING_N - 1, RING_N],
          f"elastic_zero (a): re-partitions {rec['repartition_s']}")
    check(all(bit_a.values()), f"elastic_zero (a): the shrunk run against "
          f"a clean 3-member run: {bit_a}")
    check(joined.get("view", {}).get("members") == list(range(RING_N))
          and joined.get("seeded_equal"),
          f"elastic_zero (b): the joiner {joined}")
    check(all(bit_b.values()), f"elastic_zero (b): the grown run against "
          f"a clean 4-member run: {bit_b}")
    check(taps["calls"] > 0 and taps["bitwise"]
          and taps["rows_as_reported"] and taps["all_gather_rows_equal"],
          f"elastic_zero (c): the n = 3 ring calls {taps}")
    check(rec["rep"] is not None
          and rec["rep"]["max_rel_l2"] <= ZERO_RTOL,
          f"elastic_zero (c): ZeRO-1 vs replicated at n = 3 {rec['rep']}")
    for nm in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
               "xent_bwd_dx", "xent_bwd_dw") + rows:
        check(launches.get(nm, 0) > 0,
              f"elastic_zero: kernel {nm} never launched")
    check(out["world_after"] == {"rows": None, "init_world": True},
          f"elastic_zero: the whole gang left the world {out['world_after']}"
          f", not init's")
    return launches


# hotstate_zero: elastic_zero's gang (ZeroGang: restart_zero's ZeRO-1 Adam
# flagship at depth 2, RING_N members, one rank-major row each) through
# elastic.run_elastic with the hot-state tier armed (Config.hotstate "on",
# hotstate.enable at the end of step HZ_ARM_STEP: from there the process
# streams the gang's full state as its first member to the next member's
# RAM after every step, a full snapshot every HZ_INTERVAL-th, deltas packed
# on the card between).  Run A: `--shrink 2:5:4` recovers from RAM at step
# HZ_RAM_STEP (the disk holds EZ_RECOVERED_STEP), (d) on its first delta.
# Run B: members 1-4 of slots 0-4 (row k computes sequence k, so a spare
# seated in a member's place computes what it did), the same kill (the
# member at arrival position 2, member 3) with step 3's snapshot rotted at
# hotstate.recv: recovery falls to the disk; then member 1 (the streaming
# member) is drained onto spare slot 0 at step HZ_STEPS.
HZ_INTERVAL = 3       # from step 3: a snapshot, deltas at 4 and 5
HZ_ARM_STEP = 3
HZ_STEPS = 6          # one step at n = 3 after the kill in A, two in B
HZ_SAVE_EVERY = 4     # the disk holds step 4 (EZ_RECOVERED_STEP) at the kill
HZ_RAM_STEP = 5
HZ_CORRUPT = "hotstate.recv:corrupt_silent:1:1"  # B's first receipt
HZ_MEMBERS_B, HZ_SLOTS_B, HZ_SPARE = (1, 2, 3, 4), 5, 0
HZ_WD_DEADLINE_S = 120.0
HZ_CHECK_THREADS = 3  # (d): the numpy pack, leaves in parallel, beside A
# Per float32 element of a delta, at most: the int8 payload, and an index
# (int64) and a value (float32) of its correction.
HZ_DELTA_BYTES_PER_F32 = 1 + 8 + 4


def hotstate_zero_phase(torch, mpi, ops, dev):
    """The hot-state slice's main path: elastic_zero's ZeRO-1 gang
    (ZeroGang at depth 2; rows 9 and 10 in the update, the fused loss rows
    4-6 and flash rows 1-3 in the members' steps) through
    ``elastic.run_elastic`` under ``Config(hotstate="on", elastic="on")``
    and ``hotstate.enable`` (at the end of step 3), the kernel counters set
    to 0 just before each main run and read just after.  (a) Run A,
    ``--shrink 2:5:4``: recovery settles on step 5 from RAM
    (``tm_hotstate_restored_total`` 1, ``fallback_disk`` 0 at that
    recovery), the restored state bitwise the true step-5 state, the n = 3
    loss and final state bitwise a clean 3-member run from it, every row 9
    / 10 call at n = 3 bitwise to the plain ring.  (b) Run B, the same kill
    with step 3's snapshot rotted at ``hotstate.recv``: the three
    candidates fail their digest, recovery settles on disk step 4
    (``verify_failed`` >= 1, ``fallback_disk`` 1).  (c) Then
    ``hotstate.migrate`` drains member 1 onto spare slot 0 at step 6 under
    watchdog "warn" (the disk's step 6 removed first): the migrated state
    bitwise the source's, the lease ``migrating`` with ``rank 1 -> rank
    0`` during the drain (``obs/tool.py blame --live`` renders it) and
    ``running`` after, the spare's run resumed at step 6 from its primed
    RAM; run B and the spare's step bitwise a clean run from the disk's
    step 4.  (d) On A's first delta the card's pack of the real state is
    byte-equal to the numpy pack (taken beside A on host copies).  The
    clean runs step the view's program from the true state (no disk, the
    tier off).  Reports the settings, the state's and blobs' bytes, the
    corrections per leaf kind, the publish seconds by part, the restore
    seconds and the step ms with the tier off and armed.  Every check
    raises."""
    import contextlib
    import io
    import math
    import shutil
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from torchmpi_tpu_torch import elastic, hotstate, obs, optim, watchdog
    from torchmpi_tpu_torch.faults import tool as ftool
    from torchmpi_tpu_torch.obs import tool as otool
    from torchmpi_tpu_torch.utils import restart

    ring = ops["ring"]
    log = TapLog()
    gang = ZeroGang(torch, mpi, ring, dev, log, "hotstate_zero", LM_D2)
    total, param_bytes = gang.total, gang.param_bytes
    rows = ZERO_ROWS["chunked"]
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
             "xent_bwd_dx", "xent_bwd_dw") + rows
    state_bytes = param_bytes + 2 * total * 4 + 8
    delta_est = param_bytes * HZ_DELTA_BYTES_PER_F32 // 4 + 2 * (
        total * HZ_DELTA_BYTES_PER_F32 + 12) + 8
    gen_est = state_bytes + (HZ_INTERVAL - 1) * delta_est
    budget_mb = math.ceil(2 * gen_est / (1 << 20))
    with open("/proc/meminfo") as f:
        avail = next(int(ln.split()[1]) * 1024 for ln in f
                     if ln.startswith("MemAvailable:"))
    check(avail >= 2 * gen_est + 6 * state_bytes,
          f"hotstate_zero: {avail} bytes of host RAM free, "
          f"{2 * gen_est + 6 * state_bytes} needed")
    work = tempfile.mkdtemp(prefix="hotstate_zero_")
    disk = shutil.disk_usage(work)
    need = 6 * state_bytes
    check(disk.free >= need, f"hotstate_zero: {disk.free} bytes free under "
          f"{work}, {need} needed")
    src, spare = HZ_MEMBERS_B[0], HZ_SPARE
    out = {"phase": "hotstate_zero", "members": RING_N,
           "depth": LM_D2["depth"], "optimizer": f"adam({ZERO_LR})",
           "params": total, "state_bytes": state_bytes,
           "hotstate_interval": HZ_INTERVAL, "hotstate_budget_mb": budget_mb,
           "armed_after_step": HZ_ARM_STEP, "generation_bytes_est": gen_est,
           "steps": HZ_STEPS, "save_every": HZ_SAVE_EVERY,
           "shrink": "%d:%d:%d" % EZ_KILL, "corrupt_rule": HZ_CORRUPT,
           "migrate": {"source": src, "spare": spare, "step": HZ_STEPS},
           "host_ram_free": avail}
    launches = {nm: 0 for nm in names}
    clock = _Clock()
    publishes, restores, recovers = [], [], []
    pack_check, truth = {}, {}
    cur = {"run": ""}
    world0 = mpi.runtime.world_communicator()

    def counters():
        reg = obs.registry()
        return {e: reg.counter_total(f"tm_hotstate_{e}_total")
                for e in ("streamed", "received", "dropped", "restored",
                          "verify_failed", "fallback_disk", "peer_lost",
                          "migrated")}

    def arm(label, world, rank):
        """A fresh replicator, its publish timed by part."""
        rep = hotstate.enable(world, rank=rank, interval=HZ_INTERVAL,
                              budget_mb=budget_mb)
        orig = rep.publish

        def timed(state, step, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig(state, step, **kw)
            publishes.append(dict(rep.timings, run=label, step=step,
                                  total_s=time.perf_counter() - t0))
        rep.publish = timed
        return rep

    def main_run(label, build, **kw):
        cur["run"] = label
        torch.cuda.synchronize()
        for mod in ops.values():
            mod.reset_launches()
        got = elastic.run_elastic(build, **kw)
        torch.cuda.synchronize()
        for nm in names:
            launches[nm] += sum(mod.LAUNCHES.get(nm, 0)
                                for mod in ops.values())
        return got

    snapshot = gang.snapshot

    def same(a, b):
        return {"params": all(torch.equal(x, y) for x, y in
                              zip(a["params"], b["params"])),
                "mu": torch.equal(a["mu"], b["mu"]),
                "nu": torch.equal(a["nu"], b["nu"]),
                "count": a["count"] == b["count"]}

    def clean_run(snap, step, members, steps, rows_by, name):
        """A clean run (the tier off, no faults, no disk) from the true
        state ``snap`` at ``step``."""
        hotstate.disable()
        cur["run"] = name
        record = {"losses": {}, "step_ms": {}, "repartition_s": []}
        return gang.clean_run(
            {"params": snap["params"],
             "opt": optim.AdamState(snap["count"], snap["mu"], snap["nu"])},
            step, members, steps, record, rows_by), record

    def after(label, world, rank, keep=()):
        """``after_step`` of a main run: arm the tier at the end of step
        HZ_ARM_STEP, and keep the true state after each step in ``keep``
        (by step)."""
        def fn(n, i, state):
            if i + 1 in keep:
                truth[(label, i + 1)] = snapshot(state)
            if i + 1 == HZ_ARM_STEP and not hotstate.active():
                arm(label, world, rank)
        return fn

    def leaf_np(pair):
        x, b = pair
        with np.errstate(invalid="ignore", over="ignore"):
            return hotstate._pack_delta_np([x], [b])

    def numpy_check(blob, host_new, host_base):
        # The numpy pack of the same leaves, one leaf a task: the blob is
        # the leaves' chunks in order.
        t0 = time.perf_counter()
        off, equal = 0, True
        with ThreadPoolExecutor(HZ_CHECK_THREADS) as ex:
            for want in ex.map(leaf_np, zip(host_new, host_base)):
                equal &= bool(np.array_equal(blob[off:off + want.size],
                                             want))
                off += want.size
        pack_check.update(byte_equal=equal and off == blob.size,
                          blob_bytes=int(blob.nbytes), numpy_blob_bytes=off,
                          check_seconds=time.perf_counter() - t0)

    try:
        mpi.set_config(elastic="on", hotstate="on", obs="metrics",
                       obs_dir=os.path.join(work, "obs"))
        obs.reset()
        orig_recover = restart.recover

        def timed_recover(*a, **k):
            c0 = counters()
            t0 = time.perf_counter()
            try:
                return orig_recover(*a, **k)
            finally:
                c1 = counters()
                recovers.append({"run": cur["run"],
                                 "seconds": time.perf_counter() - t0,
                                 **{e: c1[e] - c0[e] for e in c0}})

        clock.patch(restart, "recover", timed_recover)
        orig_offer = hotstate.offer_restore

        def offer(template, **kw):
            got = orig_offer(template, **kw)
            restores.append({"run": cur["run"],
                             "step": None if got is None else got[1],
                             "seconds": hotstate.replicator().timings.get(
                                 "restore_s")})
            want = truth.get((cur["run"], None if got is None else got[1]))
            if want is not None:
                truth["restored", cur["run"]] = same(snapshot(got[0]), want)
            return got

        clock.patch(hotstate, "offer_restore", offer)
        orig_pack = hotstate._pack_delta
        checker = []

        def checked_pack(new, base, staging=None):
            blob = orig_pack(new, base, staging)
            if not checker:
                # Host copies of the leaves and the blob, checked beside the
                # run (the blob lies in the reused pinned buffer).
                t0 = time.perf_counter()
                args = (blob.copy(), [hotstate._host(x) for x in new],
                        [hotstate._host(b) for b in base])
                pack_check["copy_seconds"] = time.perf_counter() - t0
                checker.append(threading.Thread(target=numpy_check,
                                                args=args, daemon=True))
                checker[0].start()
            return blob

        clock.patch(hotstate, "_pack_delta", checked_pack)

        # A: the RAM rung; member 2 dies at step 5, the gang resumes at 5.
        plan_a = os.path.join(work, "shrink.json")
        check(ftool.main(["gen", "--out", plan_a, "--seed", str(CHAOS_SEED),
                          "--shrink", "%d:%d:%d" % EZ_KILL]) == 0,
              "hotstate_zero: chaos tool --shrink")
        mpi.set_config(faults=plan_a)
        rec_a = {"losses": {}, "step_ms": {}, "repartition_s": [],
                 "rep": None, "rep_launches": {}}
        restore_taps = tap_rank_major_routes(torch, mpi, ring, log)
        ckpt_a = os.path.join(work, "ckpt_a")
        try:
            st_a, info_a = main_run(
                "a", gang.build_for(rec_a, check_n=EZ_KILL[2] - 1,
                                    after_step=after("a", RING_N, 0,
                                                     (HZ_RAM_STEP,))),
                steps=HZ_STEPS, directory=ckpt_a, save_every=HZ_SAVE_EVERY,
                members=range(RING_N), world_size=RING_N)
        finally:
            restore_taps()
        for nm, c in rec_a["rep_launches"].items():
            if nm in launches:
                launches[nm] -= c
        inbox_a = hotstate.replicator().inbox_bytes()
        fin_a = snapshot(st_a)
        del st_a
        mpi.set_config(faults="off")
        survivors = [m for m in range(RING_N) if m != EZ_KILL[0]]
        clean_a, crec_a = clean_run(truth.pop(("a", HZ_RAM_STEP)),
                                    HZ_RAM_STEP, survivors, HZ_STEPS,
                                    "member", "clean_a")
        bit_a = dict(same(fin_a, clean_a), losses=[
            rec_a["losses"][i] for i in range(HZ_RAM_STEP, HZ_STEPS)] == [
            crec_a["losses"][i] for i in range(HZ_RAM_STEP, HZ_STEPS)])
        del fin_a, clean_a
        n3 = [e for e in log if e["label"] == f"n{EZ_KILL[2] - 1}"]
        taps = {"calls": len(n3),
                "bitwise": all(e["bitwise"] for e in n3),
                "rows": sorted({tuple(e["rows"]) for e in n3})}
        shutil.rmtree(ckpt_a, ignore_errors=True)
        if checker:
            checker[0].join()
        torch.cuda.empty_cache()

        # B: the ladder's fall (step 3's snapshot rotted in the buddy's
        # RAM), then the drain of the streaming member onto the spare.
        plan_b = os.path.join(work, "shrink_corrupt.json")
        check(ftool.main(["gen", "--out", plan_b, "--seed", str(CHAOS_SEED),
                          "--shrink", "%d:%d:%d" % EZ_KILL,
                          "--rule", HZ_CORRUPT]) == 0,
              "hotstate_zero: chaos tool --shrink --rule")
        mpi.set_config(faults=plan_b, watchdog="warn",
                       watchdog_deadline_s=HZ_WD_DEADLINE_S)
        rec_b = {"losses": {}, "step_ms": {}, "repartition_s": []}
        ckpt_b = os.path.join(work, "ckpt_b")
        st_b, info_b = main_run(
            "b", gang.build_for(rec_b, rows_by="position",
                                after_step=after("b", HZ_SLOTS_B, src,
                                                 (EZ_RECOVERED_STEP,
                                                  HZ_STEPS))),
            steps=HZ_STEPS, directory=ckpt_b, save_every=HZ_SAVE_EVERY,
            members=HZ_MEMBERS_B, world_size=HZ_SLOTS_B)
        del st_b
        mpi.set_config(faults="off")
        survivors_b = tuple(info_b["view"].members)
        # The drain lands between saves: the run's closing save of step
        # HZ_STEPS goes, so the disk holds step 4 and only the stream can
        # give the spare step HZ_STEPS.
        for f in os.listdir(ckpt_b):
            if f.startswith(f"ckpt_{HZ_STEPS}_"):
                os.remove(os.path.join(ckpt_b, f))
        lease_dir = watchdog.lease_dir()
        drain = {}
        rep_b = hotstate.replicator()

        def admit(state, step):
            leases = watchdog.read_leases(lease_dir)
            drain["lease_during"] = sorted(
                (d.get("state"), d.get("state_detail"))
                for d in leases.values())
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = otool.main(["blame", "--live", lease_dir])
            drain["blame_rc"] = rc
            drain["blame_line"] = next(
                (ln.strip() for ln in text.getvalue().splitlines()
                 if "MIGRATING" in ln), None)
            drain["state_equal"] = same(snapshot(state),
                                        truth.pop(("b", HZ_STEPS)))
            rep_b.rank = spare  # this process now speaks for the spare

        cur["run"] = "drain"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tmpl = {"params": [torch.empty_like(p) for p in gang.params],
                "opt": optim.AdamState(0, torch.empty(total, device=dev),
                                       torch.empty(total, device=dev))}
        moved, moved_step = hotstate.migrate(
            src, spare, tmpl, admit=admit,
            retire=lambda r: drain.update(retired=r))
        drain["seconds"] = time.perf_counter() - t0
        drain["restore_s"] = rep_b.timings.get("restore_s")
        del moved, tmpl
        drain["lease_after"] = sorted(
            (d.get("state"), d.get("state_detail"))
            for d in watchdog.read_leases(lease_dir).values())
        drain["step"] = moved_step
        members_c = tuple(sorted((set(survivors_b) - {src}) | {spare}))
        st_c, info_c = main_run(
            "c", gang.build_for(rec_b, rows_by="position"),
            steps=HZ_STEPS + 1, directory=ckpt_b, save_every=10 ** 6,
            members=members_c, world_size=HZ_SLOTS_B)
        fin_b = snapshot(st_c)
        del st_c
        mpi.set_config(watchdog="off")
        clean_b, crec_b = clean_run(truth.pop(("b", EZ_RECOVERED_STEP)),
                                    EZ_RECOVERED_STEP, survivors_b,
                                    HZ_STEPS + 1, "position", "clean_b")
        span = range(EZ_RECOVERED_STEP, HZ_STEPS + 1)
        bit_b = dict(same(fin_b, clean_b), losses=[
            rec_b["losses"][i] for i in span] == [
            crec_b["losses"][i] for i in span])
        del fin_b, clean_b
        hz_counters = counters()
    finally:
        clock.restore()
        hotstate.disable()
        mpi.set_config(elastic="off", hotstate="off", faults="off",
                       watchdog="off", obs="off")
        if mpi.runtime.world_rows() is not None:
            mpi.runtime.restore_world()
        shutil.rmtree(work, ignore_errors=True)

    def med(xs):
        return statistics.median(xs) if xs else None

    deltas = [p for p in publishes if p["kind"] == "delta"]
    snaps = [p for p in publishes if p["kind"] == "snap"]
    parts = {k: {"delta": med([p[k] for p in deltas[1:] if k in p]),
                 "snap": med([p[k] for p in snaps if k in p])}
             for k in ("total_s", "pack_s", "device_s", "d2h_s", "copy_s",
                       "digest_s", "digest_wait_s", "deliver_s")}
    step_off = {"n3": med(crec_a["step_ms"].get(f"n{RING_N - 1}", [])
                          + crec_b["step_ms"].get(f"n{RING_N - 1}", [])),
                "n4": med(rec_a["step_ms"].get(f"n{RING_N}", [])[
                    :HZ_ARM_STEP])}
    # A's steps at n 4 with their publish (step k's after step index
    # k - 1), the one whose pack (d) checked left out.
    n4_ms = rec_a["step_ms"].get(f"n{RING_N}", [])
    checked = min((p["step"] for p in publishes
                   if p["run"] == "a" and p["kind"] == "delta"), default=None)
    armed = [n4_ms[p["step"] - 1] + p["total_s"] * 1e3 for p in publishes
             if p["run"] == "a" and p["step"] <= len(n4_ms)
             and p["step"] != checked]
    rec_a_counts = [r for r in recovers if r["run"] == "a"]
    rec_b_counts = [r for r in recovers if r["run"] == "b"]
    out.update(
        info_a=dict(info_a, view=info_a["view"].to_json()),
        info_b=dict(info_b, view=info_b["view"].to_json()),
        info_c=dict(info_c, view=info_c["view"].to_json()),
        recovers=recovers, restores=restores,
        restored_a=truth.get(("restored", "a")),
        bitwise_a_vs_clean3=bit_a, bitwise_b_and_drain_vs_clean3=bit_b,
        n3_ring_calls=taps, drain=drain, pack_check=pack_check,
        counters=hz_counters, inbox_bytes_after_a=inbox_a,
        blob_bytes={"snap": med([p["blob_bytes"] for p in snaps]),
                    "delta": med([p["blob_bytes"] for p in deltas])},
        corrections=[{"step": p["step"], **p.get("corrections", {})}
                     for p in deltas],
        publish_seconds=parts, publishes=publishes,
        step_ms_tier_off=step_off, step_ms_armed_n4=med(armed),
        losses_a=[rec_a["losses"][i] for i in sorted(rec_a["losses"])],
        launches=launches,
        world_after={"rows": mpi.runtime.world_rows(),
                     "init_world": mpi.runtime.world_communicator()
                     is world0})
    emit(out)
    check(info_a["shrinks"] == 1 and info_a["recoveries"] == [0, HZ_RAM_STEP]
          and info_a["recovered_step"] == HZ_RAM_STEP,
          f"hotstate_zero (a): info {out['info_a']}")
    check(len(rec_a_counts) == 2 and rec_a_counts[1]["restored"] == 1
          and rec_a_counts[1]["fallback_disk"] == 0,
          f"hotstate_zero (a): the shrink's recovery {rec_a_counts}")
    check(out["restored_a"] is not None and all(out["restored_a"].values()),
          f"hotstate_zero (a): the RAM-restored state vs the true step "
          f"{HZ_RAM_STEP}: {out['restored_a']}")
    check(all(bit_a.values()), f"hotstate_zero (a): the run against a clean "
          f"3-member run from step {HZ_RAM_STEP}: {bit_a}")
    check(taps["calls"] > 0 and taps["bitwise"],
          f"hotstate_zero (a): the n = 3 ring calls {taps}")
    check(info_b["recoveries"] == [0, EZ_RECOVERED_STEP]
          and info_b["shrinks"] == 1,
          f"hotstate_zero (b): info {out['info_b']}")
    check(len(rec_b_counts) == 2 and rec_b_counts[1]["verify_failed"] >= 1
          and rec_b_counts[1]["fallback_disk"] == 1
          and rec_b_counts[1]["restored"] == 0,
          f"hotstate_zero (b): the shrink's recovery {rec_b_counts}")
    check(drain.get("step") == HZ_STEPS and drain.get("retired") == src
          and all(drain.get("state_equal", {False: False}).values()),
          f"hotstate_zero (c): the drain {drain}")
    want = ("migrating", f"rank {src} -> rank {spare}")
    check(want in drain.get("lease_during", [])
          and drain.get("blame_rc") == 1 and drain.get("blame_line")
          and f"rank {src} -> rank {spare}" in drain["blame_line"],
          f"hotstate_zero (c): the lease during the drain {drain}")
    check(drain.get("lease_after") and all(
        s == "running" for s, _ in drain["lease_after"]),
        f"hotstate_zero (c): the lease after the drain {drain}")
    check(info_c["recoveries"] == [HZ_STEPS]
          and [r["restored"] for r in recovers if r["run"] == "c"] == [1],
          f"hotstate_zero (c): the spare's run {out['info_c']}")
    check(all(bit_b.values()), f"hotstate_zero (b), (c): run B and the "
          f"spare's step against a clean 3-member run from disk step "
          f"{EZ_RECOVERED_STEP}: {bit_b}")
    check(pack_check.get("byte_equal"),
          f"hotstate_zero (d): the card's pack vs numpy {pack_check}")
    for nm in names:
        check(launches.get(nm, 0) > 0,
              f"hotstate_zero: kernel {nm} never launched")
    check(out["world_after"] == {"rows": None, "init_world": True},
          f"hotstate_zero: the world after {out['world_after']}")
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
    (g), after (c): the per-op table, ``Config(backend="xla",
    backend_per_op={"allreduce": "auto"})`` on (a)'s plan file: (c)'s step
    with no measurement, bitwise to (c)'s explicit per-bucket step; then
    ``{"allreduce": "pallas"}`` with ``custom_min_bytes`` just above the
    statistics bucket: every bucket, that one too, on rows 8 / 11.
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
        def same(a, c):
            return (all(torch.equal(x, y) for x, y in zip(a[0], c[0]))
                    and all(torch.equal(x.trace, y.trace)
                            for x, y in zip(a[1], c[1]))
                    and all(torch.equal(x, y) for x, y in zip(a[2], c[2]))
                    and torch.equal(a[3], c[3]))

        reinit_bitwise = same(got, ref)

        # (g) the per-op table: backend "xla" and {"allreduce": "auto"} on
        # (a)'s plan file replays (a)'s plans with no measurement, bitwise
        # to (c)'s explicit per-bucket step; then {"allreduce": "pallas"}
        # puts every bucket on rows 8 / 11, the statistics bucket too (a
        # per-op entry bypasses the cutover).
        mpi.stop()
        dev = mpi.init(mpi.Config(
            backend="xla", backend_per_op={"allreduce": "auto"},
            tuning_plan_path=cfg.tuning_plan_path))
        tuning.reset_measurement_count()
        torch.backends.cudnn.deterministic = True
        try:
            got_g = recipes.make_bn_dp_train_step_rank_major(model, tx, n)(
                params, opt, stats, xb, yb)
            per_op_measured = tuning.measurement_count()
            mpi.set_config(backend_per_op={"allreduce": "pallas"},
                           custom_min_bytes=R50_STATS * 4 + 1)
            torch.cuda.synchronize()
            before = {k: ring.LAUNCHES[k] for k in AUTO_ROWS}
            recipes.make_bn_dp_train_step_rank_major(model, tx, n)(
                params, opt, stats, xb, yb)
            torch.cuda.synchronize()
            per_op_rows = {k: ring.LAUNCHES[k] - before[k]
                           for k in AUTO_ROWS}
        finally:
            torch.backends.cudnn.deterministic = False
        per_op_bitwise = same(got_g, ref)
        per_op_want = (spec.n_launches
                       + fusion.FusedSpec(list(stats)).n_launches)
        mpi.stop()
        dev = mpi.init(cfg)

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
                     "tuning_rounds": cfg.tuning_rounds},
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
          "per_op": {"auto_measured": per_op_measured,
                     "auto_bitwise_vs_explicit_backends": per_op_bitwise,
                     "pallas_rows": per_op_rows,
                     "pallas_launches_want": per_op_want,
                     "custom_min_bytes": R50_STATS * 4 + 1},
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
    check(per_op_measured == 0 and per_op_bitwise,
          f"(g) per-op auto: {per_op_measured} measurements, bitwise "
          f"{per_op_bitwise}")
    check(sum(per_op_rows.values()) == per_op_want,
          f"(g) per-op pallas: rows {per_op_rows}, want {per_op_want} "
          f"launches (every bucket, the statistics bucket under the "
          f"cutover too)")
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


def sp_fused_loss(torch, mpi, model, tok):
    """Stage B''s fused loss over the global sequence of the rank-major
    sequence-parallel model: tok [B, T] split into SP_N shards of T / SP_N
    (rank r holding positions r T / SP_N on), the ranks' pre-head outputs
    joined in rank order, so a shard's last token is labelled by the next
    rank's first: the single-device model's loss."""
    B, T = tok.shape
    h, head = model.forward_rank_major(
        tok.view(B, SP_N, T // SP_N).transpose(0, 1), return_prehead=True)
    h = h.transpose(0, 1).reshape(B, T, h.shape[-1])
    E = h.shape[-1]
    return mpi.ops.fused_linear_cross_entropy(
        h[:, :-1].reshape(-1, E).to(torch.bfloat16),
        head.to(torch.bfloat16), tok[:, 1:].reshape(-1)).mean()


def _sp_residual_pairs(torch, flash, seq, dev):
    """The residual kernel against its plain version at the ring's shard
    pairs (SP_PAIRS): num, m (rows with a valid key) and l within 1e-4 of
    each one's largest, two calls bitwise, the fully masked rows exactly
    (NEG_INF, 0, 0); each pair timed beside its plain version and, as
    context only, SDPA's forward on the same pair and mask."""
    Tl, H, D = SP_T // SP_N, SP_LM["num_heads"], SP_LM["head_dim"]
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    q, k, v = (torch.randn(SP_BATCH, Tl, H, D, generator=g, device=dev)
               for _ in range(3))
    out = []
    for qo, ko in SP_PAIRS:
        kw = dict(scale=1.0 / math.sqrt(D), causal=True, q_offset=qo,
                  kv_offset=ko)
        got = flash.flash_fwd_residual(q, k, v, **kw)
        again = flash.flash_fwd_residual(q, k, v, **kw)
        want = flash.flash_fwd_residual_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        live = want[2] > 0
        m_got = torch.where(live, got[1], 0.0)
        m_want = torch.where(live, want[1], 0.0)
        errs = {"num": (max_err(got[0], want[0]),
                        KERNEL_RTOL * float(want[0].abs().max())),
                "m": (max_err(m_got, m_want),
                      KERNEL_RTOL * float(m_want.abs().max())),
                "l": (max_err(got[2], want[2]),
                      KERNEL_RTOL * float(want[2].abs().max()))}
        masked = ~live
        masked_exact = bool(
            torch.equal(got[1][masked],
                        torch.full_like(got[1][masked], flash.NEG_INF))
            and (got[2][masked] == 0).all()
            and (got[0].transpose(1, 2)[masked] == 0).all())
        keep = seq.causal_window_mask(qo + torch.arange(Tl, device=dev),
                                      ko + torch.arange(Tl, device=dev))
        pairs = SP_BATCH * H * int(keep.sum())
        nbytes = 4 * (3 * q.numel() + got[0].numel() + 2 * got[1].numel())
        t_op = 4 * D * pairs / PEAK_TF32_FLOPS * 1e3
        t_b = nbytes / PEAK_HBM_BYTES * 1e3
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_ms = (time_ms(torch, lambda: torch.nn.functional.
                           scaled_dot_product_attention(
                               qt, kt, vt, attn_mask=keep,
                               scale=kw["scale"]))
                   if pairs else None)
        out.append({
            "q_offset": qo, "kv_offset": ko, "live_pairs": pairs,
            "errors": {n: e for n, (e, _) in errs.items()},
            "tolerances": {n: t for n, (_, t) in errs.items()},
            "bitwise_repeat": all(torch.equal(a, b)
                                  for a, b in zip(got, again)),
            "masked_rows": int(masked.sum()), "masked_exact": masked_exact,
            "ms": time_ms(torch, lambda: flash.flash_fwd_residual(
                q, k, v, **kw)),
            "plain_ms": time_ms(torch, lambda: flash.flash_fwd_residual_plain(
                q, k, v, **kw)),
            "bound_ms": max(t_op, t_b),
            "bound_by": "operations" if t_op >= t_b else "bytes",
            "sdpa_context_ms": sdpa_ms})
        del got, again, want
    return out


def _sp_attention_alone(torch, flash, seq, dev):
    """ring_flash and ulysses_flash attention alone, float32, rank-major,
    SP_N ranks at [SP_BATCH, SP_T, 16, 128] (causal), against
    flash_attention_grad over the whole sequence: o, dq, dk, dv within 1e-4
    of each reference's largest; each fwd + bwd timed beside the
    single-device one."""
    n, B, T = SP_N, SP_BATCH, SP_T
    H, D = SP_LM["num_heads"], SP_LM["head_dim"]
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, device=dev)
                   for _ in range(4))
    def stack(t):
        return t.view(B, n, T // n, H, D).transpose(0, 1).contiguous()

    def whole(t):
        return t.transpose(0, 1).reshape(B, T, H, D)

    def run(fn, xs, dout, **kw):
        xs = [x.detach().requires_grad_() for x in xs]
        o = fn(*xs, causal=True, **kw)
        o.backward(dout)
        return [o.detach()] + [x.grad for x in xs]

    single = flash.flash_attention_grad
    ref = run(single, (q, k, v), do)
    out = {}
    fns = {"ring_flash": seq.ring_attention_rank_major,
           "ulysses_flash": seq.ulysses_attention_rank_major}
    for name, sp in fns.items():
        got = run(sp, [stack(t) for t in (q, k, v)], stack(do),
                  block_impl="flash")
        errs = {}
        for what, a, b in zip(("o", "dq", "dk", "dv"), got, ref):
            errs[what] = (max_err(whole(a), b),
                          KERNEL_RTOL * float(b.abs().max()))
        out[name] = {
            "errors": {w: e for w, (e, _) in errs.items()},
            "tolerances": {w: t for w, (_, t) in errs.items()},
            "fwd_bwd_ms": time_ms(torch, lambda sp=sp: run(
                sp, [stack(t) for t in (q, k, v)], stack(do),
                block_impl="flash"), iters=3, warmup=1)}
        del got
    out["single_device_fwd_bwd_ms"] = time_ms(
        torch, lambda: run(single, (q, k, v), do), iters=3, warmup=1)
    return out


def longcontext_sp_phase(torch, mpi, ops, dev):
    """The sequence-parallel slice's main path: the flagship's widths
    (SP_LM: 16 kv heads, RoPE, bf16, no window) over one sequence of SP_T
    tokens as SP_N ranks rank-major on the card, stage B''s fused loss
    over the global sequence (sp_fused_loss), SGD lr 0.02.  Checks, each
    raising: the residual kernel at the ring's shard pairs; ring_flash
    and ulysses_flash attention alone against the whole sequence's
    flash_attention_grad; each sequence-parallel model's loss and
    gradients on the seed weights against the single-device flash model
    (rel. L2 2e-2); 0 host syncs a step; every kernel of each path
    launched in its steps; the example longcontext_lm to the JAX bar with
    ring_flash and with ulysses; the ring through the NCCL world of one
    against flash_attention.  Timed: ring_flash one warm-up and
    TIMED_STEPS steps, ulysses_flash one and 3, each with its peak memory
    and one more step profiled by part.  Every kernel counter is set to 0
    just before each path's steps and read just after; returns the
    residual kernel's row and each kernel's launches summed over both
    paths."""
    flash = ops["flash"]
    seq = mpi.parallel.sequence
    t_phase = time.perf_counter()
    pairs = _sp_residual_pairs(torch, flash, seq, dev)
    alone = _sp_attention_alone(torch, flash, seq, dev)
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    models = {"ring_flash": mpi.models.TransformerLM(
        **SP_LM, attn_impl="ring_flash", seq_axis="ici",
        dtype=torch.bfloat16, device=dev, generator=g)}
    tok = torch.randint(0, SP_LM["vocab"], (SP_BATCH, SP_T), generator=g,
                        device=dev)
    single = mpi.models.TransformerLM(**SP_LM, attn_impl="flash",
                                      dtype=torch.bfloat16, device=dev)
    single.load_state_dict(models["ring_flash"].state_dict())
    models["ulysses_flash"] = mpi.models.TransformerLM(
        **SP_LM, attn_impl="ulysses_flash", seq_axis="ici",
        dtype=torch.bfloat16, device=dev)
    models["ulysses_flash"].load_state_dict(single.state_dict())
    n_params = sum(p.numel() for p in single.parameters())
    ref = _loss_and_grads(single,
                          lambda: fused_lm_loss(torch, mpi, single, tok))
    del single
    for name, model in models.items():
        _compare(f"{name} rank-major ({SP_N} ranks) vs single-device flash, "
                 f"T {SP_T}", _loss_and_grads(
                     model, lambda m=model: sp_fused_loss(torch, mpi, m, tok)),
                 ref)
        model.zero_grad(set_to_none=True)
    del ref
    torch.cuda.empty_cache()

    paths = {}
    for name, model in models.items():
        opt = torch.optim.SGD(model.parameters(), lr=LR)

        def step(model=model, opt=opt):
            opt.zero_grad(set_to_none=True)
            loss = sp_fused_loss(torch, mpi, model, tok)
            loss.backward()
            opt.step()
            return loss.detach()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in ops.values():
            mod.reset_launches()
        losses, step_ms = [], []
        for i in range(1 + SP_TIMED[name]):
            t0 = time.perf_counter()
            losses.append(float(step()))  # waits for the step
            if i:
                step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k: c for mod in ops.values()
                    for k, c in mod.LAUNCHES.items()
                    if k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                             "flash_fwd_residual", "xent_fwd",
                             "xent_bwd_dx", "xent_bwd_dw")}
        peak = torch.cuda.max_memory_allocated()
        syncs = count_host_syncs(torch, step)
        profile = step_profile(torch, step, step_parts=SP_STEP_PARTS)
        med = statistics.median(step_ms)
        paths[name] = {
            "losses": losses, "warmup_steps": 1, "step_ms": step_ms,
            "median_step_ms": med, "min_step_ms": min(step_ms),
            "max_step_ms": max(step_ms),
            "tokens_per_s": SP_BATCH * SP_T / (med / 1e3),
            "peak_mem_bytes": peak, "host_syncs_per_step": syncs,
            "launches": launches,
            "launches_per_step": {k: c // (1 + SP_TIMED[name])
                                  for k, c in launches.items()},
            "step_device_profile": profile}
        del opt
        torch.cuda.empty_cache()
    del models
    torch.cuda.empty_cache()

    # The example on the card, in-process (a world of one; --devices 4
    # runs its ranks rank-major), to the JAX bar.
    from torchmpi_tpu_torch.examples import longcontext_lm

    examples = []
    for argv in SP_EXAMPLES:
        t0 = time.perf_counter()
        res = longcontext_lm.main(list(argv))
        examples.append({"argv": list(argv), "first": res["first"],
                         "last": res["last"], "learned": res["learned"],
                         "seconds": time.perf_counter() - t0})

    # The ring through the process world of one (NCCL): one call equal to
    # flash_attention on the same tensors.
    Tl, H, D = SP_T // SP_N, SP_LM["num_heads"], SP_LM["head_dim"]
    g = torch.Generator(device=dev).manual_seed(SEED + 24)
    q, k, v = (torch.randn(1, Tl, H, D, generator=g, device=dev)
               for _ in range(3))
    o_ring = seq.ring_attention(q, k, v, "ici", causal=True,
                                block_impl="flash")
    o_flash = flash.flash_attention(q, k, v, causal=True)
    world = {"world_size": mpi.size(), "ring_size": mpi.runtime.ici_size(),
             "max_abs_err": max_err(o_ring, o_flash),
             "tolerance": KERNEL_RTOL * float(o_flash.abs().max()),
             "bitwise": bool(torch.equal(o_ring, o_flash))}

    full = pairs[0]
    row = {"name": "flash_fwd_residual", "route": "cuda",
           "source": SOURCES["flash_fwd_residual"][0],
           "replaces": SOURCES["flash_fwd_residual"][1],
           "max_abs_err": full["errors"]["num"],
           "tolerance": full["tolerances"]["num"],
           "errors": full["errors"], "tolerances": full["tolerances"],
           "ms": full["ms"], "plain_ms": full["plain_ms"],
           "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
           "library_ms": None,
           "library_call": ("none returns (num, m, l); SDPA's forward on "
                            "the same pair and mask, context only: "
                            f"{full['sdpa_context_ms']} ms"),
           "bitwise_repeat": full["bitwise_repeat"]}
    by_path = {name: p["launches"] for name, p in paths.items()}
    emit({"phase": "longcontext_sp", "ranks": SP_N,
          "config": dict(SP_LM, batch=SP_BATCH, seq=SP_T, lr=LR,
                         dtype="bfloat16"),
          "params": n_params, "residual_pairs": pairs,
          "attention_alone": alone, "paths": paths,
          "launches_by_path": by_path, "examples": examples,
          "world_of_one_ring": world,
          "seconds": time.perf_counter() - t_phase})
    for pr in pairs:
        for w, e in pr["errors"].items():
            check(e <= pr["tolerances"][w],
                  f"flash_fwd_residual at {pr['q_offset']}, "
                  f"{pr['kv_offset']}: {w} err {e} > {pr['tolerances'][w]}")
        check(pr["bitwise_repeat"], "flash_fwd_residual: two calls differ")
        check(pr["masked_exact"], f"flash_fwd_residual's masked rows at "
              f"{pr['q_offset']}, {pr['kv_offset']} are not (NEG_INF, 0, 0)")
    check(pairs[2]["masked_rows"] == SP_BATCH * SP_LM["num_heads"]
          * (SP_T // SP_N), "the pair ahead is not fully masked")
    for name in ("ring_flash", "ulysses_flash"):
        for w, e in alone[name]["errors"].items():
            check(e <= alone[name]["tolerances"][w],
                  f"{name} attention: {w} err {e} > "
                  f"{alone[name]['tolerances'][w]}")
    for name, p in paths.items():
        check(all(math.isfinite(x) for x in p["losses"]),
              f"{name}: non-finite loss {p['losses']}")
        check(p["losses"][-1] < p["losses"][0],
              f"{name}: loss did not fall: {p['losses']}")
        check(p["host_syncs_per_step"] == 0,
              f"{name}: {p['host_syncs_per_step']} host syncs in a step")
        for k in SP_PATH_KERNELS[name]:
            check(p["launches"][k] > 0,
                  f"kernel {k} never launched on the {name} path")
    check(paths["ring_flash"]["launches"]["flash_fwd"] == 0,
          "the ring_flash path launched the plain forward kernel")
    for ex in examples:
        check(ex["learned"], f"longcontext_lm {ex['argv']} missed the bar")
    check(world["max_abs_err"] <= world["tolerance"],
          f"the ring in the world of one vs flash_attention: {world}")
    sp_launches = {k: sum(p["launches"].get(k, 0) for p in paths.values())
                   for k in SOURCES}
    return row, sp_launches


def _ep_experts(params, tokens):
    a, b = params
    return (tokens @ a).tanh() @ b


def _ep_oracle(torch, x, gate, w1, w2, k, cf):
    """The per-token plain oracle of one expert layer (tests/test_expert.py
    ``_oracle_topk``): x [n, T, D] of n ranks, each rank's routes counted
    in GShard's order on the host (top-k by a stable sort, ties to the
    lower expert), each routed token through its expert directly.  Returns
    the output and the routing (experts, slots, valid) as numpy."""
    import numpy as np

    n, T, D = x.shape
    E = w1.shape[0]
    C = max(1, int(cf * T * k / E))
    probs = torch.softmax(x @ gate, dim=-1)
    top = np.argsort(-probs.detach().cpu().numpy(), axis=-1,
                     kind="stable")[..., :k]
    slot = np.empty((n, T, k), np.int64)
    for r in range(n):
        counts = [0] * E
        for j in range(k):
            for t in range(T):
                e = top[r, t, j]
                slot[r, t, j] = counts[e]
                counts[e] += 1
    valid = slot < C
    e_idx = torch.from_numpy(top).to(x.device)
    sel = probs.gather(-1, e_idx)
    w = sel / sel.sum(-1, keepdim=True).clamp_min(1e-9) if k > 1 else sel
    w = w * torch.from_numpy(valid).to(x.device)
    Y = torch.stack([(x @ w1[e]).tanh() @ w2[e] for e in range(E)], dim=2)
    rows = Y.gather(2, e_idx[..., None].expand(n, T, k, D))
    return (rows * w[..., None]).sum(2), (top, slot, valid)


def _ep_layer_alone(torch, ep, dev):
    """One expert layer at the flagship's shapes, float32, 4 ranks as dcn
    2 x ici 2 (the group over ici): for each (k, capacity factor) of
    EP_LAYER_CASES the routing of topk_dispatch against the oracle's count
    (identical), the output and the gate / w1 / w2 gradients of sum(out *
    w) within 1e-4 of each reference's largest, two calls bitwise; fwd +
    bwd timed beside the oracle's."""
    import numpy as np

    (n_dcn, n_ici), n = EP_GRID, EP_GRID[0] * EP_GRID[1]
    T, D = SEQ, LM["embed"]
    E = EP_LM["moe_experts_per_device"] * n_ici
    H = 4 * D
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    x = torch.randn(n_dcn, n_ici, T, D, generator=g, device=dev)
    wo = torch.randn(n_dcn, n_ici, T, D, generator=g, device=dev)
    gate = torch.randn(D, E, generator=g, device=dev) / math.sqrt(D)
    w1 = torch.randn(E, D, H, generator=g, device=dev) / math.sqrt(D * E)
    w2 = torch.randn(E, H, D, generator=g, device=dev) / math.sqrt(H * E)

    def run(fn):
        ps = [t.detach().requires_grad_() for t in (gate, w1, w2)]
        out = fn(*ps)
        (out * wo).sum().backward()
        return [out.detach()] + [p.grad for p in ps]

    cases = []
    for k, cf in EP_LAYER_CASES:
        layer = lambda gt, a, b, k=k, cf=cf: ep.moe_layer_rank_major(  # noqa
            x, gt, _ep_experts, (a, b), "ici", capacity_factor=cf, k=k)
        got, again = run(layer), run(layer)
        routing = {}

        def oracle(gt, a, b, k=k, cf=cf):
            out, routing["r"] = _ep_oracle(torch, x.view(n, T, D), gt, a, b,
                                           k, cf)
            return out.view(x.shape)

        ref = run(oracle)
        top, slot, valid = routing["r"]
        C = max(1, int(cf * T * k / E))
        probs = torch.softmax(x.view(n, T, D) @ gate, dim=-1)
        _, _, eo, so, va = ep.topk_dispatch(x.view(n, T, D), None, E, C, k,
                                            renormalize=k > 1, probs=probs)
        errs = {w: max_err(a, b) for w, a, b in
                zip(("out", "gate", "w1", "w2"), got, ref)}
        tols = {w: KERNEL_RTOL * float(b.abs().max())
                for w, b in zip(("out", "gate", "w1", "w2"), ref)}
        cases.append({
            "k": k, "capacity_factor": cf, "capacity": C,
            "routing_equal": bool(
                np.array_equal(eo.cpu().numpy(), top)
                and np.array_equal(so.cpu().numpy(), slot)
                and np.array_equal(va.cpu().numpy(), valid)),
            "dropped_share": float(1.0 - valid.mean()),
            "errors": errs, "tolerances": tols,
            "bitwise_repeat": all(torch.equal(a, b)
                                  for a, b in zip(got, again)),
            "fwd_bwd_ms": time_ms(torch, lambda f=layer: run(f), iters=3,
                                  warmup=1),
            "oracle_fwd_bwd_ms": time_ms(torch, lambda f=oracle: run(f),
                                         iters=3, warmup=1)})
        del got, again, ref
    torch.cuda.empty_cache()
    return cases


def _ep_loss(torch, mpi, model, tok):
    """Stage B''s fused loss over every rank's rows of the rank-major MoE
    model (tok [n_dcn, n_ici, B, T]), plus EP_AUX times the layers'
    load-balance losses (their sum, the mean over the ranks)."""
    h, head = model.forward_rank_major(tok, return_prehead=True)
    E = h.shape[-1]
    task = mpi.ops.fused_linear_cross_entropy(
        h[..., :-1, :].reshape(-1, E).to(torch.bfloat16),
        head.to(torch.bfloat16), tok[..., 1:].reshape(-1)).mean()
    return task + EP_AUX * sum(model.moe_aux_losses()).mean()


def _ep_routes(torch, ep, model, tok):
    """Each MoE layer's routing on one more forward of ``model`` (tok
    [n_dcn, n_ici, B, T]; its inputs caught by forward hooks and routed
    again by topk_dispatch): per layer (experts [n, B * T, k], valid)."""
    n_dcn, n_ici, B, T = tok.shape
    routes, hooks = [], []

    def catch(moe, args, _out):
        x = args[0].reshape(n_dcn * n_ici, B * T, -1)
        E, k = moe.n_experts, moe.k
        C = max(1, int(moe.capacity_factor * B * T * k / E))
        probs = torch.softmax(x @ moe.gate, dim=-1)
        _, _, expert_of, _, valid = ep.topk_dispatch(x, None, E, C, k,
                                                     probs=probs)
        routes.append((expert_of, valid, E * C))

    for blk in model.blocks:
        hooks.append(blk.moe.register_forward_hook(catch))
    try:
        with torch.no_grad():
            model.forward_rank_major(tok, return_prehead=True)
    finally:
        for h in hooks:
            h.remove()
    return routes


def _ep_model(torch, mpi, dev, dtype, **over):
    """The moe_ep model (EP_LM, flash attention, compute ``dtype``, with
    ``over`` replacing its fields) and the grid's tokens [n_dcn, n_ici, 1,
    SEQ], both from the phase's seed: equal weights for every dtype."""
    n_dcn, n_ici = EP_GRID
    g = torch.Generator(device=dev).manual_seed(SEED + 33)
    kw = {**EP_LM, "moe_axis_size": n_ici, **over}
    model = mpi.models.TransformerLM(**kw, attn_impl="flash", dtype=dtype,
                                     device=dev, generator=g)
    tok = torch.randint(0, LM["vocab"], (n_dcn, n_ici, 1, SEQ), generator=g,
                        device=dev)
    return model, tok


def _ep_oracles(torch, mpi, ep, dev):
    """The MoE step on the grid against its local oracles, on the phase's
    seed weights: (a) each rank's row alone through the same weights with
    all 4 experts local (grid 1 x 1, moe_experts_per_device 4; JAX's
    oracle), in float32 compute, checked by _compare (rel. L2 2e-2); (b)
    the 4 ranks folded as the grid folds them but each its own group of
    one with all experts local (moe_axis "dcn" of a 1 x 4 grid: the same
    products, no exchange), bf16, checked bitwise; (c) (a) in bf16,
    reported: the differently shaped bf16 products of a lone row round
    otherwise, and tokens near a top-2 tie change experts (the flips a
    layer are counted).  Returns the bf16 grid model and its tokens."""
    n = EP_GRID[0] * EP_GRID[1]
    local = dict(moe_experts_per_device=EP_GRID[1] * EP_LM[
        "moe_experts_per_device"], moe_axis_size=1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model, tok = _ep_model(torch, mpi, dev, dtype)
        grid = _loss_and_grads(model, lambda: _ep_loss(torch, mpi, model,
                                                        tok))
        grid = (grid[0], {k: g.clone() for k, g in grid[1].items()})
        model.zero_grad(set_to_none=True)
        grid_routes = _ep_routes(torch, ep, model, tok)
        alone = _ep_model(torch, mpi, dev, dtype, **local)[0]
        alone.load_state_dict(model.state_dict())
        loss, routes = 0.0, []
        for r in range(n):
            row = tok.view(n, 1, 1, 1, SEQ)[r]
            loss_r = _ep_loss(torch, mpi, alone, row) / n
            loss_r.backward()
            loss += float(loss_r.detach())
            routes.append(_ep_routes(torch, ep, alone, row))
        ref = (loss, {k: p.grad for k, p in alone.named_parameters()})
        del alone
        flips = [int((g[0] != torch.cat([r[i][0] for r in routes])
                      ).any(-1).sum()) for i, g in enumerate(grid_routes)]
        name = (f"moe_ep {str(dtype).split('.')[-1]} grid vs each rank "
                f"alone, all experts local")
        if dtype == torch.float32:
            _compare(name, grid, ref)
        else:
            loss_rel = abs(grid[0] - ref[0]) / abs(ref[0])
            rel = {k: float((grid[1][k].float() - g.float()).norm()
                            / g.float().norm().clamp_min(1e-30))
                   for k, g in ref[1].items()}
            worst = max(rel, key=rel.get)
            emit({"phase": "consistency", "compare": name,
                  "reported_only": True, "loss_rel_diff": loss_rel,
                  "grad_max_rel_norm_diff": rel[worst],
                  "worst_grad": worst, "route_flips_per_layer": flips})
            ones = _ep_model(torch, mpi, dev, dtype, moe_axis="dcn",
                             **local)[0]
            ones.load_state_dict(model.state_dict())
            one = _loss_and_grads(ones, lambda: _ep_loss(
                torch, mpi, ones, tok.view(1, n, 1, SEQ)))
            _compare("moe_ep bf16 grid vs the ranks as groups of one, all "
                     "experts local", grid, one)
            out["groups_of_one_bitwise"] = grid[0] == one[0] and all(
                torch.equal(grid[1][k], g) for k, g in one[1].items())
            del ones, one
        out[str(dtype).split(".")[-1]] = {"route_flips_per_layer": flips}
        del ref, grid
        torch.cuda.empty_cache()
    emit({"phase": "moe_ep_oracles", **out})
    check(out["groups_of_one_bitwise"], "moe_ep bf16 grid vs groups of one: "
          "not bitwise")
    check(not any(out["float32"]["route_flips_per_layer"]),
          f"moe_ep float32: routing differs from each rank alone: {out}")
    model.zero_grad(set_to_none=True)
    return model, tok


def moe_ep_phase(torch, mpi, ops, dev):
    """The expert-parallel slice's main path: the flagship with its MLP an
    expert layer (EP_LM: moe_axis "ici", 2 experts a rank, top-2, capacity
    factor 2.0), rank-major on the dcn 2 x ici 2 grid, one row of 2048
    tokens a rank, the fused loss plus 1e-2 of the aux losses, SGD lr
    0.02.  Checks, each raising: the layer alone against its per-token
    oracle (_ep_layer_alone); the process world of one (NCCL) bitwise to
    the rank-major form at n = 1; the step's loss and gradients on the
    seed weights against its local oracles (_ep_oracles); one warm-up
    and TIMED_STEPS steps, the loss finite and falling, 0 host syncs,
    rows 1-6 launched and every head launch on wgmma; the example moe_lm
    --devices 4 --dcn 2 --top-k 2 to the JAX bar.  Every kernel counter is
    set to 0 just before the timed steps and read just after; returns each
    kernel's launches."""
    ep = mpi.parallel.expert
    t_phase = time.perf_counter()
    alone = _ep_layer_alone(torch, ep, dev)

    # The process world of one: all experts local, no exchange.
    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    D, E = LM["embed"], 4
    x = torch.randn(SEQ, D, generator=g, device=dev)
    gate = torch.randn(D, E, generator=g, device=dev) / math.sqrt(D)
    w1 = torch.randn(E, D, 4 * D, generator=g, device=dev) / math.sqrt(D * E)
    w2 = torch.randn(E, 4 * D, D, generator=g, device=dev) / math.sqrt(
        4 * D * E)
    kw = dict(capacity_factor=EP_LM["moe_capacity_factor"], k=EP_LM["moe_k"])
    o_world = ep.moe_layer(x, gate, _ep_experts, (w1, w2), "ici", **kw)
    o_rm = ep.moe_layer_rank_major(x[None], gate, _ep_experts, (w1, w2),
                                   "ici", **kw)
    world = {"world_size": mpi.size(), "axis_size": mpi.runtime.ici_size(),
             "bitwise": bool(torch.equal(o_world, o_rm[0])),
             "max_abs_err": max_err(o_world, o_rm[0])}
    del x, gate, w1, w2, o_world, o_rm

    n = EP_GRID[0] * EP_GRID[1]
    model, tok = _ep_oracles(torch, mpi, ep, dev)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.empty_cache()

    opt = torch.optim.SGD(model.parameters(), lr=LR)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = _ep_loss(torch, mpi, model, tok)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in ops.values():
        mod.reset_launches()
    losses, step_ms = [], []
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step()))  # waits for the step
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: c for mod in ops.values() for k, c in mod.LAUNCHES.items()
                if k in EP_PATH_KERNELS}
    routes = {k: dict(c) for k, c in ops["xent"].ROUTE_LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    syncs = count_host_syncs(torch, step)
    profile = step_profile(torch, step, step_parts=EP_STEP_PARTS)
    routing = [{"dropped_share": float(1.0 - valid.float().mean()),
                "slot_fill": float(valid.sum()) / (n * slots)}
               for _, valid, slots in _ep_routes(torch, ep, model, tok)]
    med = statistics.median(step_ms)
    del opt, model
    torch.cuda.empty_cache()

    # The example on the card, in-process (a world of one; --devices 4 runs
    # its ranks rank-major as dcn 2 x ici 2), to the JAX bar.
    from torchmpi_tpu_torch.examples import moe_lm

    t0 = time.perf_counter()
    res = moe_lm.main(list(EP_EXAMPLE))
    example = {"argv": list(EP_EXAMPLE), "first": res["first"],
               "last": res["last"], "learned": res["learned"],
               "seconds": time.perf_counter() - t0}

    emit({"phase": "moe_ep", "grid": list(EP_GRID),
          "config": dict(EP_LM, batch_per_rank=1, seq=SEQ, lr=LR,
                         aux_scale=EP_AUX, dtype="bfloat16",
                         experts_dtype="float32"),
          "params": n_params, "layer_alone": alone,
          "world_of_one": world, "losses": losses, "warmup_steps": 1,
          "step_ms": step_ms, "median_step_ms": med,
          "min_step_ms": min(step_ms), "max_step_ms": max(step_ms),
          "tokens_per_s": n * SEQ / (med / 1e3), "peak_mem_bytes": peak,
          "host_syncs_per_step": syncs, "launches": launches,
          "launches_per_step": {k: c // (1 + TIMED_STEPS)
                                for k, c in launches.items()},
          "xent_route_launches": routes, "routing": routing,
          "step_device_profile": profile, "example": example,
          "seconds": time.perf_counter() - t_phase})
    for c in alone:
        what = f"expert layer alone k {c['k']} cf {c['capacity_factor']}"
        check(c["routing_equal"], f"{what}: routing differs from the oracle")
        check(c["bitwise_repeat"], f"{what}: two calls differ")
        for w, e in c["errors"].items():
            check(e <= c["tolerances"][w],
                  f"{what}: {w} err {e} > {c['tolerances'][w]}")
    check(world["bitwise"], f"the MoE layer in the world of one vs the "
          f"rank-major form at n = 1: {world}")
    check(all(math.isfinite(v) for v in losses), f"moe_ep: non-finite loss "
          f"{losses}")
    check(losses[-1] < losses[0], f"moe_ep: loss did not fall: {losses}")
    check(syncs == 0, f"moe_ep: {syncs} host syncs in a step")
    for k in EP_PATH_KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the moe_ep path")
    for k, counts in routes.items():
        check(counts == {r: launches[k] * (r == "wgmma")
                         for r in ops["xent"].ROUTES},
              f"{k}: moe_ep head launches off the wgmma route: {counts}")
    check(example["learned"], f"moe_lm {example['argv']} missed the bar: "
          f"{example['first']} -> {example['last']}")
    return launches


def _mg_full_weights(torch, dev, L, seed):
    """The L full (unsharded) blocks' weights [L, d_in, d_out] in the
    ``x @ w`` layout, scaled as the example's (1 / sqrt(d_in))."""
    D, F = MG["embed"], MG["ffn"]
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D),
              "w1": (D, F), "w2": (F, D)}
    return {k: torch.randn(L, a, b, generator=g, device=dev) / math.sqrt(a)
            for k, (a, b) in shapes.items()}


def _mg_rank_major(torch, full, S, n_dp, n_tp, V, K):
    """The full blocks as the rank-major stacks [n, V, K, ...]: rank (p, d,
    t) of the (pp, dp, tp) grid row-major holds tp shard t (a column block,
    a row block of wo / w2) of logical chunk v S + p's K blocks, for each
    v (replicated over dp)."""
    out = {}
    for k, w in full.items():
        L, a, b = w.shape
        sh = (w.reshape(L, n_tp, a // n_tp, b) if k in ("wo", "w2") else
              w.reshape(L, a, n_tp, b // n_tp).transpose(1, 2))
        c = sh.reshape(V, S, K, n_tp, *sh.shape[2:]).permute(1, 3, 0, 2, 4, 5)
        c = c.unsqueeze(1).expand(S, n_dp, *c.shape[1:])
        out[k] = c.reshape(S * n_dp * n_tp, V, K, *sh.shape[2:]).contiguous()
    return out


def _mg_full_grads(torch, grads, d, S, n_dp, n_tp, V, K):
    """Rank-major gradients [n, V, K, ...] back in the full blocks' layout
    [L, d_in, d_out], from the ranks of dp group ``d``."""
    out = {}
    for k, gk in grads.items():
        sh = gk.reshape(S, n_dp, n_tp, V, K, *gk.shape[3:])[:, d]
        sh = sh.permute(2, 0, 3, 1, 4, 5).reshape(S * V * K, n_tp,
                                                  *gk.shape[3:])
        L = sh.shape[0]
        out[k] = (sh.reshape(L, -1, sh.shape[-1]) if k in ("wo", "w2") else
                  sh.transpose(1, 2).reshape(L, sh.shape[2], -1))
    return out


def _mg_oracle(torch, flash, full, xs, ys):
    """The sequential oracle on the card: the same blocks unsharded, applied
    in order to every microbatch of every dp group (all 16 heads in one
    flash call a block), the JAX example's loss (each group's squared error
    over its target's size, the mean over the groups); each microbatch's
    backward accumulated into the full weights' gradients.  Returns (loss,
    outputs [n_dp, M, B, T, D], gradients [L, d_in, d_out])."""
    H, W = MG["heads"], MG["window"]
    w = {k: v.detach().clone().requires_grad_() for k, v in full.items()}
    n_dp, M = xs.shape[:2]
    size = xs[0].numel()

    def ln(h):
        mu = h.mean(-1, keepdim=True)
        var = ((h - mu) ** 2).mean(-1, keepdim=True)
        return (h - mu) * torch.rsqrt(var + 1e-6)

    outs, loss = torch.empty_like(xs), 0.0
    for d in range(n_dp):
        for m in range(M):
            h = xs[d, m]
            B, T, D = h.shape
            for l in range(w["wq"].shape[0]):
                q, k, v = ((ln(h) @ w[n][l]).reshape(B, T, H, D // H)
                           for n in ("wq", "wk", "wv"))
                ctx = flash.flash_attention_grad(q, k, v, causal=True,
                                                 window=W)
                h = h + ctx.reshape(B, T, D) @ w["wo"][l]
                h = h + torch.nn.functional.gelu(ln(h) @ w["w1"][l]) \
                    @ w["w2"][l]
            part = ((h - ys[d, m]) ** 2).sum() / size / n_dp
            part.backward()
            outs[d, m] = h.detach()
            loss += float(part.detach())
    return loss, outs, {k: v.grad for k, v in w.items()}


def _mg_check_step(torch, mp, flash, params, xs_rm, ys_rm, oracle, grid,
                   schedule, V, K):
    """One step of ``schedule`` (SGD lr 0: the weights stay) against the
    oracle: the last stage's outputs within MG_OUT_TOL, every weight's
    gradient (each block, each dp group's ranks) within MG_GRAD_RTOL
    (rel. L2), the loss.  Returns the errors."""
    S, n_dp, n_tp = grid
    ref_loss, ref_out, ref_grads = oracle
    stage_fn = mp.make_stage_fn(MG["heads"], MG["embed"], xs_rm.device,
                                rank_major=True, attn_impl="flash",
                                window=MG["window"], backend="pallas")
    step = mp.make_train_step(stage_fn, S, schedule=schedule, lr=0.0,
                              rank_major=True, backend="pallas")
    loss, grads = step(params, xs_rm, ys_rm)
    with torch.no_grad():
        out = step.apply(params, xs_rm)
    R = n_dp * n_tp
    out_err = 0.0
    for r in range((S - 1) * R, S * R):
        d = (r // n_tp) % n_dp
        diff = (out[r] - ref_out[d]).abs() - MG_OUT_TOL["rtol"] * \
            ref_out[d].abs()
        out_err = max(out_err, float(diff.max()))
    del out
    rel = {}
    for d in range(n_dp):
        full = _mg_full_grads(torch, grads, d, S, n_dp, n_tp, V, K)
        for k, g in full.items():
            for l in range(g.shape[0]):
                name = f"{k}[{l}] dp{d}"
                rel[name] = float((g[l] - ref_grads[k][l]).norm()
                                  / ref_grads[k][l].norm())
    worst = max(rel, key=rel.get)
    return {"schedule": schedule, "loss": float(loss[0]),
            "oracle_loss": ref_loss,
            "loss_rel_diff": abs(float(loss[0]) - ref_loss) / ref_loss,
            "out_excess_over_rtol": out_err, "out_tol": MG_OUT_TOL,
            "within_jax_atol": out_err <= MG_JAX_ATOL,
            "grad_max_rel_l2": rel[worst], "worst_grad": worst}


def _mg_profile(torch, fn) -> dict:
    """Device time of one call of ``fn`` by part (MG_STEP_PARTS, on the
    kernels' names) and by range (MG_RANGES: the kernels launched inside
    each record_function range), and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    parts = {name: {"ms": 0.0, "calls": 0} for name, _ in MG_STEP_PARTS}
    parts["other"] = {"ms": 0.0, "calls": 0}
    ranges = {r: {"ms": 0.0, "calls": 0} for r in MG_RANGES}
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = (getattr(e, "cuda_time_total", 0.0) if t is None else t) / 1e3
        if e.key in ranges:
            ranges[e.key] = {"ms": t, "calls": e.count}
        elif e.device_type == DeviceType.CUDA and t > 0:
            rows.append((e.key, e.count, t))
            part = next((n for n, pat in MG_STEP_PARTS
                         if re.search(pat, e.key)), "other")
            parts[part]["ms"] += t
            parts[part]["calls"] += e.count
    rows.sort(key=lambda r: -r[2])
    return {"total_ms": sum(r[2] for r in rows), "parts": parts,
            "ranges": ranges,
            "top": [{"kernel": k[:120], "calls": c, "ms": ms}
                    for k, c, ms in rows[:12]]}


def _mg_world_of_one(torch, mpi, mp, dev):
    """The process world of one (NCCL, mesh_shape pp 1 x dp 1 x tp 1): one
    GPipe step of MG_WORLD_BLOCKS full-width blocks (all 16 heads on the
    one rank, 2 microbatches) in the process-world form against the
    rank-major form at n = 1 on the same weights and data: the loss, every
    gradient and every updated weight bitwise."""
    full = _mg_full_weights(torch, dev, MG_WORLD_BLOCKS, SEED + 42)
    rm = _mg_rank_major(torch, full, 1, 1, 1, 1, MG_WORLD_BLOCKS)
    world = {k: v[0].clone() for k, v in rm.items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 43)
    shape = (1, 2, MG["batch"], MG["seq"], MG["embed"])
    xs = torch.randn(*shape, generator=g, device=dev)
    ys = torch.randn(*shape, generator=g, device=dev) * 0.3
    res = {}
    for rank_major, params, x, y in ((True, rm, xs, ys),
                                     (False, world, xs[0], ys[0])):
        stage_fn = mp.make_stage_fn(MG["heads"], MG["embed"], dev,
                                    rank_major=rank_major,
                                    attn_impl="flash", window=MG["window"],
                                    backend="pallas")
        step = mp.make_train_step(stage_fn, 1, schedule="gpipe", lr=MG_LR,
                                  rank_major=rank_major, backend="pallas")
        loss, grads = step(params, x, y)
        res[rank_major] = (loss, grads, params)
    (l_rm, g_rm, p_rm), (l_w, g_w, p_w) = res[True], res[False]
    return {"world_size": mpi.size(), "shape": mpi.world_shape(),
            "backend": mpi.runtime.backend_name(),
            "bitwise": bool(torch.equal(l_w, l_rm) and all(
                torch.equal(g_w[k], g_rm[k][0]) and
                torch.equal(p_w[k], p_rm[k][0]) for k in g_w)),
            "max_abs_err": max(max_err(g_w[k], g_rm[k][0]) for k in g_w)}


def megatron_3d_phase(torch, mpi, ops, dev):
    """The tensor- and pipeline-parallel slice's main path: MG's stack of 8
    Megatron blocks at the flagship's widths, rank-major on mesh_shape pp
    2 x dp 2 x tp 2 (8 ranks on the card), GPipe over pp (4 blocks a
    stage), 4 microbatches of 1 x 2048 tokens a dp group, flash attention
    (window 1024), the f / g and dp allreduces on backend "pallas", the
    JAX example's regression loss, SGD lr 2e-3.  Checks, each raising: the
    process world of one (NCCL) bitwise to the rank-major form at n = 1;
    one GPipe step and one interleaved step (V 2, 2 blocks a chunk)
    against the sequential oracle on the card (outputs within MG_OUT_TOL,
    the loss within MG_LOSS_RTOL, every weight's gradient within rel. L2
    1e-4; the GPipe step with TF32 products as the control, reported),
    every ring launch of those steps bitwise to the plain ring (the
    selector's "pallas" route tapped); one warm-up and TIMED_STEPS steps, the loss finite and
    falling, 0 host syncs, rows 1-3 launched a known number of times; a
    pushed communicator ("half", shape ici 4) planned on its own key; the
    example megatron_pipeline --devices 8 --dp 2, both schedules, to the
    JAX bar.  Every kernel counter is set to 0 just before the warm-up and
    read after the timed steps.  Restores the two-level world of one;
    returns each kernel's launches and the device."""
    from torchmpi_tpu_torch.examples import megatron_pipeline as mp

    flash, ring = ops["flash"], ops["ring"]
    t_phase = time.perf_counter()
    mpi.stop()
    mpi.init(mpi.Config(mesh_shape={"pp": 1, "dp": 1, "tp": 1}))
    world = _mg_world_of_one(torch, mpi, mp, dev)
    mpi.stop()
    dev = mpi.init(mpi.Config(mesh_shape=MG_SHAPE))
    torch.cuda.empty_cache()

    S, n_dp, n_tp = (MG_SHAPE[a] for a in ("pp", "dp", "tp"))
    n, L, M = S * n_dp * n_tp, MG["blocks"], MG["microbatches"]
    full = _mg_full_weights(torch, dev, L, SEED + 40)
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    shape = (n_dp, M, MG["batch"], MG["seq"], MG["embed"])
    xs = torch.randn(*shape, generator=g, device=dev)
    ys = torch.randn(*shape, generator=g, device=dev) * 0.3
    rows = [d for _ in range(S) for d in range(n_dp) for _ in range(n_tp)]
    xs_rm, ys_rm = xs[rows].contiguous(), ys[rows].contiguous()
    oracle = _mg_oracle(torch, flash, full, xs, ys)
    torch.cuda.empty_cache()

    # The checked steps, every ring launch held to the plain ring.
    log = TapLog()
    restore = tap_rank_major_routes(torch, mpi, ring, log,
                                    ops=("allreduce_rank_major",))
    checks = []
    try:
        for schedule, V, K in (("gpipe", 1, L // S),
                               ("interleaved", 2, L // (2 * S))):
            params = _mg_rank_major(torch, full, S, n_dp, n_tp, V, K)
            checks.append(_mg_check_step(torch, mp, flash, params, xs_rm,
                                         ys_rm, oracle, (S, n_dp, n_tp),
                                         schedule, V, K))
            del params
            torch.cuda.empty_cache()
        # The control: the GPipe step with TF32 products, whose readings
        # the limits must stay under.
        params = _mg_rank_major(torch, full, S, n_dp, n_tp, 1, L // S)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            control = _mg_check_step(torch, mp, flash, params, xs_rm, ys_rm,
                                     oracle, (S, n_dp, n_tp), "gpipe", 1,
                                     L // S)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        control["tf32_products"] = True
        control["limits_below_control"] = (
            control["out_excess_over_rtol"] > MG_OUT_TOL["atol"]
            and control["loss_rel_diff"] > MG_LOSS_RTOL
            and control["grad_max_rel_l2"] > MG_GRAD_RTOL)
        del params
        torch.cuda.empty_cache()
    finally:
        restore()
    tapped_rows = sorted({r for e in log for r in e["rows"]})
    tap = {"calls": len(log), "bitwise": all(e["bitwise"] for e in log),
           "rows": tapped_rows}
    del log, oracle
    torch.cuda.empty_cache()

    # The main path: one warm-up and TIMED_STEPS GPipe steps.
    params = _mg_rank_major(torch, full, S, n_dp, n_tp, 1, L // S)
    n_params = sum(v[0].numel() for v in params.values()) * S * n_tp
    del full
    stage_fn = mp.make_stage_fn(MG["heads"], MG["embed"], dev,
                                rank_major=True, attn_impl="flash",
                                window=MG["window"], backend="pallas")
    train = mp.make_train_step(stage_fn, S, schedule="gpipe", lr=MG_LR,
                               rank_major=True, backend="pallas")

    def step():
        return train(params, xs_rm, ys_rm)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (flash, ring):
        mod.reset_launches()
    losses, step_ms = [], []
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step()[0]))  # waits for the step
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: c for k, c in flash.LAUNCHES.items()
                if k in MG_PATH_KERNELS}
    launches.update({k: c for k, c in ring.LAUNCHES.items() if c})
    vector = {k: c for k, c in ring.VECTOR_LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated()
    syncs = count_host_syncs(torch, step)
    profile = _mg_profile(torch, step)
    med = statistics.median(step_ms)
    del params, train
    torch.cuda.empty_cache()

    # Back to the two-level world of one for the later phases; a pushed
    # communicator there, planned on its own key.
    mpi.stop()
    dev = mpi.init()
    x = torch.randn(8, 1 << 20, generator=g, device=dev)
    mpi.allreduce_rank_major(x)
    mpi.planner.reset_stats()
    with mpi.communicator("half", shape={"ici": 4}):
        half = mpi.allreduce_rank_major(x[:4])
        misses = mpi.planner.stats()["misses"]
    mpi.allreduce_rank_major(x)
    pushed = {"equal_to_plain_sum": bool(torch.equal(
        half, mpi.collectives._fold_ranks(x[:4]).expand(4, -1))),
        "misses_under_push": misses,
        "world_hits_after_pop": mpi.planner.stats()["hits"]}
    del x, half

    examples = []
    for argv in MG_EXAMPLES:
        t0 = time.perf_counter()
        res = mp.main(list(argv))
        examples.append({"argv": list(argv), "first": res["first"],
                         "last": res["last"], "drop": res["drop"],
                         "learned": res["learned"],
                         "seconds": time.perf_counter() - t0})

    ticks = M + S - 1
    per_step = ticks * (L // S)
    emit({"phase": "megatron_3d", "mesh_shape": MG_SHAPE,
          "config": dict(MG, blocks_per_stage=L // S, lr=MG_LR,
                         dtype="float32", attn_impl="flash",
                         backend="pallas", schedule="gpipe"),
          "params": n_params, "world_of_one": world, "checks": checks,
          "control": control,
          "ring_tap": tap, "losses": losses, "warmup_steps": 1,
          "step_ms": step_ms, "median_step_ms": med,
          "min_step_ms": min(step_ms), "max_step_ms": max(step_ms),
          "tokens_per_s": n_dp * M * MG["batch"] * MG["seq"] / (med / 1e3),
          "peak_mem_bytes": peak, "host_syncs_per_step": syncs,
          "launches": launches, "vector_launches": vector,
          "launches_per_step": {k: c // (1 + TIMED_STEPS)
                                for k, c in launches.items()},
          "flash_launches_per_step_expected": per_step,
          "step_device_profile": profile, "pushed_communicator": pushed,
          "examples": examples, "seconds": time.perf_counter() - t_phase})
    check(world["bitwise"], f"megatron_3d: the world of one vs the "
          f"rank-major form at n = 1: {world}")
    for c in checks:
        check(c["out_excess_over_rtol"] <= MG_OUT_TOL["atol"],
              f"megatron_3d {c['schedule']}: outputs off the oracle: {c}")
        check(c["grad_max_rel_l2"] <= MG_GRAD_RTOL,
              f"megatron_3d {c['schedule']}: gradients off the oracle: {c}")
        check(c["loss_rel_diff"] <= MG_LOSS_RTOL,
              f"megatron_3d {c['schedule']}: loss off the oracle: {c}")
    check(tap["calls"] > 0 and tap["bitwise"] and tap["rows"],
          f"megatron_3d: ring launches vs the plain ring: {tap}")
    check(all(math.isfinite(v) for v in losses),
          f"megatron_3d: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"megatron_3d: loss did not fall: {losses}")
    check(syncs == 0, f"megatron_3d: {syncs} host syncs in a step")
    for k in MG_PATH_KERNELS:
        check(launches[k] == per_step * (1 + TIMED_STEPS),
              f"megatron_3d: {k} launched {launches[k]} times, expected "
              f"{per_step} a step")
    check(any(k.startswith("ring") for k in launches),
          f"megatron_3d: no ring row launched: {launches}")
    check(pushed["equal_to_plain_sum"] and pushed["misses_under_push"] == 1
          and pushed["world_hits_after_pop"] >= 1,
          f"megatron_3d: the pushed communicator: {pushed}")
    for ex in examples:
        check(ex["learned"], f"megatron_pipeline {ex['argv']} missed the "
              f"bar: {ex['first']} -> {ex['last']}")
    return launches, dev


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


def _serve_trace(np, serving, unit_s: float):
    """The lm_serving trace from SEED: SERVE_REQUESTS requests, their
    prompts, budgets, sampling and Poisson arrivals (mean gap mean(max_new)
    / (SERVE_LOAD x SERVE_SLOTS) decode steps of ``unit_s`` seconds)."""
    rng = np.random.RandomState(SEED)
    n, V = SERVE_REQUESTS, LM["vocab"]
    lens = rng.randint(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, size=n)
    news = rng.randint(SERVE_MAX_NEW[0], SERVE_MAX_NEW[1] + 1, size=n)
    prompts = [rng.randint(0, V, size=int(L)) for L in lens]
    sampled = set(rng.choice(n, SERVE_SAMPLED, replace=False).tolist())
    gap = float(np.mean(news)) / (SERVE_LOAD * SERVE_SLOTS) * unit_s
    arrivals = np.cumsum(rng.exponential(gap, size=n))

    def make(order=None):
        out = []
        for i in range(n):
            kw = (dict(SERVE_SAMPLING, seed=SEED * 1000 + i)
                  if i in sampled else {})
            out.append(serving.Request(f"s{i}", prompts[i],
                                       max_new=int(news[i]),
                                       arrival_s=float(arrivals[i]), **kw))
        return out

    return make, sampled, gap


def _pcts(xs) -> dict:
    xs = sorted(xs)
    if not xs:
        return {"p50": None, "p99": None, "n": 0}
    return {"p50": xs[len(xs) // 2],
            "p99": xs[min(len(xs) - 1, int(0.99 * len(xs)))], "n": len(xs)}


def _top2_margin(torch, logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


class _LocalAttention:
    """Within the block, ``model``'s attention runs the plain reference
    (``attn_impl="local"``): the full forwards the checks recompute never
    launch a flash kernel."""

    def __init__(self, model):
        self.mods = [m for m in model.modules() if hasattr(m, "attn_impl")]

    def __enter__(self):
        self.saved = [m.attn_impl for m in self.mods]
        for m in self.mods:
            m.attn_impl = "local"

    def __exit__(self, *exc):
        for m, impl in zip(self.mods, self.saved):
            m.attn_impl = impl


def _cached_greedy(torch, gen_mod, model, prompt, n: int):
    """``generate``'s greedy path, the same calls (the steps one CUDA
    graph each), keeping each step's logits: (tokens [n], logits [n,
    V])."""
    with torch.no_grad():
        cache = model.init_cache(1)

        def step(tok, pos):
            return model(tok[:, None], pos, cache=cache)[:, 0].float()

        pos = torch.full((1,), prompt.numel(), dtype=torch.long,
                         device=prompt.device)
        step = gen_mod.graphed(step, prompt[:1], pos)
        xs, head = model(prompt[None], 0, return_prehead=True, cache=cache)
        logits = [(xs[:, -1] @ head).float()]
        for i in range(1, n):
            logits.append(step(logits[-1].argmax(-1), pos + (i - 1)).clone())
    logits = torch.cat(logits)
    return logits.argmax(-1), logits


def serve_step_profile(torch, gen_mod, tmod, fn) -> dict:
    """Device ms of one call of ``fn`` (an eager decode step) by part: the
    products (every ``linear`` / ``matmul`` outside attention), attention
    (``SPAttention._decode`` less its cache writes: RoPE, the mask, the
    einsums and softmax), the cache writes (its ``index_put_``), sampling
    (``generate._sample_rows``) and the rest (layer norms, GELU, residuals,
    the embedding).  The two functions run inside profiler ranges for the
    call; each kernel counts where the first of its launching op's
    ancestors that names a part puts it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    decode, sample = tmod.SPAttention._decode, gen_mod._sample_rows

    def ranged(name, f):
        def g(*a, **k):
            with record_function(name):
                return f(*a, **k)
        return g

    tmod.SPAttention._decode = ranged("serve/attention", decode)
    gen_mod._sample_rows = ranged("serve/sampling", sample)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        tmod.SPAttention._decode, gen_mod._sample_rows = decode, sample
    parts = {k: 0.0 for k in ("products", "attention", "cache writes",
                              "sampling", "other")}
    for e in prof.events():
        ms = sum(k.duration for k in getattr(e, "kernels", [])) / 1e3
        if ms <= 0:
            continue
        names, p = [], e
        while p is not None:
            names.append(p.name)
            p = p.cpu_parent
        if "serve/sampling" in names:
            part = "sampling"
        elif "serve/attention" in names:
            part = ("cache writes" if any("index_put" in n for n in names)
                    else "attention")
        elif any(n in ("aten::linear", "aten::addmm", "aten::matmul",
                       "aten::mm") for n in names):
            part = "products"
        else:
            part = "other"
        parts[part] += ms
    return {"total_ms": sum(parts.values()), "parts_ms": parts}


def lm_serving_phase(torch, mpi, ops, dev):
    """The serving slice's main path: the flagship LM at full width
    (LM, seed weights, attn_impl "flash" as trained; decode attends
    through einsums against the cache, as JAX's) served by
    ``serving.Server`` over one ``ReplicaEngine`` of SERVE_SLOTS slots of
    2048 tokens, float32 with TF32 off, on _serve_trace's Poisson trace
    under the wall clock.  First a burst at 16 live slots measures the
    decode step (the trace's unit_seconds; the step's device ms by part;
    (h): exactly 1 host sync a decode step and 1 a prefill), then the
    trace (rows 1-14 counters set to 0 just before it and read just after:
    (g), 0 each), then the checks, each raising: (a) the cached decode's
    logits of SERVE_CHECKED greedy requests against a full forward of the
    same tokens within SERVE_LOGIT_RTOL x max |ref|, no token differing
    at a top-2 margin above the error; (b) every greedy stream equal to
    offline ``generate`` of its prompt alone, a mismatch allowed only at
    a top-2 margin under (a)'s error (reported); (c) a reused slot of the
    trace's pool decodes bitwise as a fresh pool's; (d) the sampled
    requests' streams bitwise on SERVE_SLOTS and on 4 slots in reversed
    arrival order; (e) n-gram speculation (K SERVE_SPEC_K) equal to the
    plain streams with fewer target forwards; (f) a prefix-cache hit
    bitwise to the miss.  Then the same trace at bf16 compute, timed,
    (b) on half of (a)'s requests, (c) and (d) reported only.  Reports output
    tokens/s, TTFT and ITL p50 / p99, the step ms at 16 live slots
    (median, min, max) and its bound, prefill ms by prompt length, peak
    memory."""
    import importlib

    import numpy as np

    from torchmpi_tpu_torch import serving

    gen_mod = importlib.import_module("torchmpi_tpu_torch.models.generate")
    tmod = importlib.import_module("torchmpi_tpu_torch.models.transformer")
    t_phase = time.perf_counter()
    secs, t_mark = {}, [t_phase]

    def mark(name):
        now = time.perf_counter()
        secs[name] = now - t_mark[0]
        t_mark[0] = now

    V, S, L = LM["vocab"], SERVE_SLOTS, LM["max_len"]
    model = mpi.models.TransformerLM(
        **LM, attn_impl="flash", device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED + 2))
    model.eval()
    on_dev = lambda a: torch.as_tensor(np.asarray(a)).to(dev)  # noqa: E731
    # Warm-up (cuBLAS handles, the allocator): a short offline decode.
    mpi.models.generate(model, np.zeros((1, 128), np.int64), 4)
    torch.cuda.synchronize()

    # The burst: 16 requests admitted, then decode steps at 16 live slots.
    make, sampled, _ = _serve_trace(np, serving, 1.0)
    eng = serving.ReplicaEngine(model, slots=S, slot_tokens=L)
    burst = [serving.Request(f"b{i}", r.prompt, max_new=SERVE_BURST_STEPS
                             + 8) for i, r in enumerate(make()[:S])]
    prefill_ms, syncs = [], {}
    for i, r in enumerate(burst):
        t = time.perf_counter()
        if i == 1:
            syncs["prefill"] = count_host_syncs(torch, lambda: eng.admit(r))
        else:
            eng.admit(r)
        prefill_ms.append([int(r.prompt.size),
                           (time.perf_counter() - t) * 1e3])
    check(eng.active == S, f"burst: {eng.active} live slots, want {S}")
    eng.step()
    syncs["decode_step"] = count_host_syncs(torch, eng.step)
    step_ms = []
    for _ in range(SERVE_BURST_STEPS):
        check(eng.active == S, "burst: a slot retired early")
        t = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - t) * 1e3)
    # By part on the eager step: the graph replays the same kernels, and
    # the profiler attributes a graph's kernels to no op.
    eng._step = eng._decode
    step_parts = serve_step_profile(torch, gen_mod, tmod, eng.step)
    check(syncs == {"prefill": 1, "decode_step": 1},
          f"(h) host syncs {syncs}, want 1 a prefill and 1 a decode step")
    unit_s = statistics.median(step_ms) / 1e3
    mark("burst")
    # S1 / S2 on the flagship's slot decode and verify ticks at the pool's
    # shapes: the aten graphs of make_fx under fake tensors (nothing
    # runs), every cache write proven in range and through the clamp.
    from torchmpi_tpu_torch import analysis

    pool = model.init_cache(S, L)

    def decode_tick(ks, vs, toks, pos):
        return gen_mod.slot_decode_step(model, tmod.KVCache(ks, vs), toks,
                                        pos)[1]

    def verify_tick(ks, vs, toks, pos):
        return gen_mod.slot_verify_step(model, tmod.KVCache(ks, vs), toks,
                                        pos)[1]

    zl = lambda *shape: torch.zeros(shape, dtype=torch.long,  # noqa: E731
                                    device=dev)
    t_s = time.perf_counter()
    s_rules = {
        "slot_decode": analysis.check(decode_tick, pool.k, pool.v, zl(S),
                                      zl(S), rules=["S1", "S2"]),
        "slot_verify": analysis.check(verify_tick, pool.k, pool.v,
                                      zl(S, SERVE_SPEC_K + 1), zl(S),
                                      rules=["S1", "S2"])}
    s_secs = time.perf_counter() - t_s
    del pool
    emit({"phase": "lm_serving_s_rules", "slots": S, "slot_tokens": L,
          "findings": {k: [str(f) for f in v] for k, v in s_rules.items()},
          "seconds": s_secs})
    check(all(v == [] for v in s_rules.values()),
          f"lm_serving S1 / S2: {s_rules}")
    mark("s_rules")
    del eng
    torch.cuda.empty_cache()
    w_bytes = 4 * sum(p.numel() for n, p in model.named_parameters()
                      if n != "embed.weight")
    cache_bytes = 2 * LM["depth"] * S * L * LM["num_kv_heads"] * \
        LM["head_dim"] * 4
    flops = 2 * w_bytes / 4 * S
    bound_ms = max((w_bytes + cache_bytes) / PEAK_HBM_BYTES,
                   flops / 67e12) * 1e3

    # The trace, float32: the main path.
    make, sampled, gap_s = _serve_trace(np, serving, unit_s)
    for mod in ops.values():
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    srv = serving.Server(model, replicas=1, slots=S, slot_tokens=L)
    reqs = make()
    t = time.perf_counter()
    done = srv.run_trace(reqs)
    trace_s = time.perf_counter() - t
    launches = {n: c for mod in ops.values() for n, c in mod.LAUNCHES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(done) == SERVE_REQUESTS and all(r.error is None for r in reqs),
          "trace: a request failed")
    check(not any(launches.values()),
          f"(g) the serving path launched table kernels: {launches}")
    main_eng = srv.router.replicas[0]
    plain = {r.rid: list(r.tokens) for r in reqs}
    mark("trace")

    def trace_numbers(server, rs):
        s_ = server.last_stats
        return {"tokens": s_["tokens"], "busy_s": s_["busy_s"],
                "tokens_per_s": s_["tokens"] / s_["busy_s"],
                "ttft_ms": {k: (v * 1e3 if isinstance(v, float) else v)
                            for k, v in _pcts([r.ttft_s for r in rs]).items()},
                "itl_ms": {k: (v * 1e3 if isinstance(v, float) else v)
                           for k, v in _pcts(s_["itl_s"]).items()},
                "ticks": s_["ticks"]}

    # (a) cached vs recomputed logits.
    greedy = [r for r in reqs if r.temperature is None]
    a_rows, a_err, offline = [], 0.0, {}
    for r in greedy[:SERVE_CHECKED]:
        prompt = on_dev(r.prompt)
        toks, logits = _cached_greedy(torch, gen_mod, model, prompt,
                                      r.max_new)
        offline[r.rid] = toks.tolist()
        with torch.no_grad(), _LocalAttention(model):
            full = model(torch.cat([prompt, toks[:-1]])[None])[0].float()
        ref = full[prompt.numel() - 1:]
        err = float((logits - ref).abs().max())
        top = float(ref.abs().max())
        margin = _top2_margin(torch, ref)
        flips = (logits.argmax(-1) != ref.argmax(-1))
        under = margin[margin <= err]
        a_rows.append({"rid": r.rid, "max_abs_err": err, "max_abs_ref": top,
                       "min_top2_margin": float(margin.min()),
                       "positions_under_err": int(under.numel()),
                       "largest_margin_under_err":
                           float(under.max()) if under.numel() else None,
                       "flips": int(flips.sum())})
        check(err <= SERVE_LOGIT_RTOL * top,
              f"(a) {r.rid}: cached logits {err} off, > "
              f"{SERVE_LOGIT_RTOL} x {top}")
        check(not bool((flips & (margin > err)).any()),
              f"(a) {r.rid}: a token differs at a margin above {err}")
        a_err = max(a_err, err)

    def judge(model_, rs, offline, err):
        """(b): each stream against its offline stream; a mismatch at a
        top-2 margin above ``err`` is a failure, one under it a
        report."""
        out = []
        for r in rs:
            off = offline[r.rid]
            if r.tokens == off:
                continue
            j = next(i for i, (x, y) in enumerate(zip(r.tokens, off))
                     if x != y)
            with torch.no_grad(), _LocalAttention(model_):
                seq = on_dev(np.concatenate([r.prompt, off[:j]]))
                m = float(_top2_margin(torch, model_(seq[None])[0, -1]))
            out.append({"rid": r.rid, "at": j, "margin": m,
                        "above_err": m > err})
        return out

    mark("a")

    # (b) every greedy stream against offline generate of its prompt alone
    # (for (a)'s requests, (a)'s decode: generate's greedy path, the same
    # calls, checked on the first).
    r0 = greedy[0]
    check(mpi.models.generate(model, r0.prompt[None], r0.max_new)[
        0, r0.prompt.size:].tolist() == offline[r0.rid],
          "(a)'s decode is not generate's")
    offline.update({r.rid: mpi.models.generate(
        model, r.prompt[None], r.max_new)[0, r.prompt.size:].tolist()
        for r in greedy[SERVE_CHECKED:]})
    b_mism = judge(model, greedy, offline, a_err)
    check(not any(m["above_err"] for m in b_mism),
          f"(b) greedy streams differ from offline generate: {b_mism}")

    # (c) a reused slot (the trace's pool, every row written) against a
    # fresh pool, row S // 3, bitwise.
    def reuse(model_, dirty):
        r = greedy[0]
        one, first = gen_mod.slot_prefill(model_, on_dev(r.prompt[None]),
                                          max_len=L)
        fresh, row = model_.init_cache(S, L), S // 3
        for pool in (dirty, fresh):
            gen_mod.slot_write(pool, one, row)
        tok, same = first, True
        toks = torch.zeros(S, dtype=torch.long, device=dev)
        pos = torch.zeros(S, dtype=torch.long, device=dev)
        for i in range(SERVE_REUSE_STEPS):
            toks[row], pos[row] = tok[0], r.prompt.size + i
            with torch.no_grad():
                ld = model_(toks[:, None], pos, cache=dirty)[row, 0]
                lf = model_(toks[:, None], pos, cache=fresh)[row, 0]
            same = same and bool(torch.equal(ld, lf))
            tok = ld.argmax(-1, keepdim=True)
        return same

    mark("b")
    c_same = reuse(model, main_eng._cache)
    check(c_same, "(c) the reused slot's logits differ from a fresh pool's")
    mark("c")

    # (d) the sampled requests on 4 slots, in reversed arrival order.
    def layouts(model_, ref_streams):
        rs = [r for r in make() if r.temperature is not None]
        arr = [r.arrival_s for r in rs]
        for r, a in zip(rs, arr[::-1]):
            r.arrival_s = a
        srv4 = serving.Server(model_, replicas=1, slots=4, slot_tokens=L)
        srv4.run_trace(rs)
        return [r.rid for r in rs if r.tokens != ref_streams[r.rid]]

    d_diff = layouts(model, plain)
    check(not d_diff, f"(d) sampled streams differ across layouts: {d_diff}")
    mark("d")

    # (e) n-gram speculation: the same streams, fewer target forwards.
    srv_e = serving.Server(model, replicas=1, slots=S, slot_tokens=L,
                           spec_k=SERVE_SPEC_K)
    e_reqs = make()
    srv_e.run_trace(e_reqs)
    eng_e = srv_e.router.replicas[0]
    e_diff = [r.rid for r in e_reqs if r.tokens != plain[r.rid]]
    e_stats = dict(eng_e.stats)
    fwd_plain = main_eng.stats["prefills"] + main_eng.stats["steps"]
    fwd_spec = eng_e.stats["prefills"] + eng_e.stats["steps"]
    check(not e_diff, f"(e) speculative streams differ: {e_diff}")
    check(fwd_spec < fwd_plain,
          f"(e) {fwd_spec} target forwards with speculation, {fwd_plain} "
          f"without")
    mark("e")

    # (f) a prefix-cache hit against the miss, bitwise.
    rng = np.random.RandomState(SEED + 5)
    shared = rng.randint(0, V, size=SERVE_PREFIX)

    def prefix_reqs():
        r2 = np.random.RandomState(SEED + 6)
        return [serving.Request(
            f"f{i}", np.concatenate([shared, r2.randint(0, V,
                                                        size=SERVE_TAIL)]),
            max_new=32, arrival_s=0.0,
            **(dict(SERVE_SAMPLING, seed=7 + i) if i % 2 else {}))
            for i in range(SERVE_PREFIX_REQS)]

    streams = []
    for cap in (0, 64):
        srv_f = serving.Server(model, replicas=1, slots=4, slot_tokens=L,
                               prefix_cache=cap,
                               prefix_block=SERVE_PREFIX_BLOCK)
        f_reqs = prefix_reqs()
        srv_f.run_trace(f_reqs)
        streams.append({r.rid: r.tokens for r in f_reqs})
    f_hits = srv_f.router.replicas[0].stats["prefix_hits"]
    check(streams[0] == streams[1] and f_hits > 0,
          f"(f) prefix hits {f_hits}; streams equal "
          f"{streams[0] == streams[1]}")
    for mod in ops.values():
        check(not any(mod.LAUNCHES.values()),
              "(g) the phase launched a table kernel")
    f32 = trace_numbers(srv, reqs)
    mark("f")

    # The same trace at bf16 compute, timed; (b) on half of (a)'s
    # requests, (c) and (d) reported only.
    del srv, srv_e, srv_f, main_eng, eng_e
    torch.cuda.empty_cache()
    model_bf = mpi.models.TransformerLM(**LM, attn_impl="flash",
                                        dtype=torch.bfloat16, device=dev)
    model_bf.load_state_dict(model.state_dict())
    model_bf.eval()
    srv_bf = serving.Server(model_bf, replicas=1, slots=S, slot_tokens=L)
    bf_reqs = make()
    srv_bf.run_trace(bf_reqs)
    bf_greedy = [r for r in bf_reqs if r.temperature is None]
    mark("bf16 trace")
    bf_off = {r.rid: mpi.models.generate(model_bf, r.prompt[None],
                                         r.max_new)[0, r.prompt.size:]
              .tolist() for r in bf_greedy[:SERVE_CHECKED // 2]}
    bf = dict(trace_numbers(srv_bf, bf_reqs),
              b_mismatches=judge(model_bf, bf_greedy[:SERVE_CHECKED // 2],
                                 bf_off, a_err),
              c_reused_slot_bitwise=reuse(model_bf,
                                          srv_bf.router.replicas[0]._cache),
              d_layout_diffs=layouts(model_bf, {r.rid: r.tokens
                                                for r in bf_reqs}),
              f32_streams_equal=sum(r.tokens == plain[r.rid]
                                    for r in bf_reqs))
    mark("bf16 checks")
    emit({"phase": "lm_serving", "config": dict(LM, attn_impl="flash"),
          "slots": S, "slot_tokens": L, "requests": SERVE_REQUESTS,
          "sampled": len(sampled), "load": SERVE_LOAD,
          "unit_seconds": unit_s, "mean_gap_s": gap_s,
          "float32": dict(f32, trace_wall_s=trace_s, peak_mem_gb=peak_gb,
                          step_ms_16_live={
                              "median": statistics.median(step_ms),
                              "min": min(step_ms), "max": max(step_ms)},
                          step_bound_ms=bound_ms,
                          step_bound_bytes=w_bytes + cache_bytes,
                          step_device_profile=step_parts,
                          prefill_ms_by_len=sorted(prefill_ms),
                          host_syncs=syncs),
          "seconds_by_part": secs,
          "a_cached_vs_recomputed": {"max_abs_err": a_err,
                                     "requests": a_rows},
          "b_greedy_vs_generate": {"requests": len(greedy),
                                   "mismatches": b_mism},
          "c_reused_slot_bitwise": c_same,
          "d_layouts_bitwise": not d_diff,
          "e_spec": {"equal": not e_diff, "target_forwards": fwd_spec,
                     "plain_forwards": fwd_plain,
                     "drafted": e_stats["spec_drafted"],
                     "accepted": e_stats["spec_accepted"]},
          "f_prefix_hits": f_hits,
          "g_table_launches": sum(launches.values()),
          "bfloat16": bf, "seconds": time.perf_counter() - t_phase})
    del model, model_bf, srv_bf
    torch.cuda.empty_cache()


def _ps_judge(torch, logits_fn, rs, streams, err):
    """Each request's stream against ``streams`` (its reference tokens):
    at the first difference, the reference's top-2 margin there (from
    ``logits_fn(tokens) -> [T, V]`` on the prompt and the reference's
    prefix); a margin above ``err`` is a failure, one under it a report."""
    out = []
    for r in rs:
        got, ref = list(r.tokens), list(streams[r.rid])
        if got == ref:
            continue
        j = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                 min(len(got), len(ref)))
        seq = np.concatenate([np.asarray(r.prompt), ref[:j]]).astype(
            np.int64)
        m = float(_top2_margin(torch, logits_fn(seq)[-1]))
        out.append({"rid": r.rid, "at": j, "margin": m,
                    "above_err": m > err})
    return out


def _ps_oracle_check(torch, oracle, params, rs, err):
    """(a): every greedy stream against the dense oracle, teacher-forced on
    the stream itself (one full forward a request): each position's token
    must be the oracle's argmax unless the oracle's top-2 margin there is
    under ``err``.  Returns the positions that differ (with margins)."""
    import numpy as np

    out = []
    for r in rs:
        seq = np.concatenate([np.asarray(r.prompt), r.tokens[:-1]])
        lg = oracle.dense_logits(params, seq[None].astype(np.int64),
                                 LM["num_heads"])[0, len(r.prompt) - 1:]
        arg = lg.argmax(-1).cpu().numpy()
        diff = np.nonzero(arg != np.asarray(r.tokens))[0]
        if diff.size:
            margin = _top2_margin(torch, lg[diff])
            out += [{"rid": r.rid, "at": int(j), "margin": float(m),
                     "above_err": float(m) > err}
                    for j, m in zip(diff, margin.tolist())]
        del lg
    return out


def parallel_serving_phase(torch, mpi, ops, dev):
    """The mesh-parallel serving slice's main path: the init_tp_lm tree at the
    flagship's widths (PSV_*: seed weights, float32, TF32 off) served by
    ``Server.sharded(tp=PSV_TP, replicas=PSV_REPLICAS, slots=PSV_SLOTS,
    slot_tokens=2048, backend="pallas")`` rank-major on the card, on
    _serve_trace's Poisson trace under the wall clock (the sublayers' sums
    on rows 11 and 8 under chunk_bytes PSV_CHUNK_BYTES; then the trace's
    first PSV_BIDIR_REQUESTS requests with pallas_bidirectional, rows 12
    and 7).  First a burst at PSV_SLOTS live slots on one replica measures
    the decode step (median, min, max; the ring rows' launches and device
    ms a step; 1 host sync a step and 1 a prefill).  Every kernel counter
    is set to 0 just before the two traces and read just after.  Checks,
    each raising: (a) the TP logits of SERVE_CHECKED greedy requests (the
    decode path, teacher-forced) against ``oracle.dense_logits`` within
    SERVE_LOGIT_RTOL x max |ref|; every greedy stream of both traces
    against the oracle and against the offline ``tp_generate`` of its
    prompt alone, a difference allowed only at a top-2 margin under that
    error; PSV_SAMPLED_CHECKED sampled streams bitwise on 4 slots in
    reversed arrival order; speculation (K SERVE_SPEC_K) and a prefix-cache
    hit bitwise to the plain streams; both replicas served and each has its
    plan row; (b) ``pp_generate`` over PSV_PP's 4 stages against the oracle
    (the margin rule), ms a token; (c) ``generate_parallel`` of the moe_ep
    model at float32 (EP_LM on dcn 2 x ici 2) against each row decoded
    alone with all experts local, and of the flagship with Ulysses
    attention (MHA) over 4 ranks against the same weights' single-device
    ``generate``, ``beam_search_parallel`` with one beam equal to greedy
    for both, then PSV_EXAMPLES to their JAX assertions; (d) every ring row
    the traces launched, tapped on a prefill and a decode step of the same
    stacks, bitwise to the plain ring.  Returns each kernel's launches."""
    import gc
    import importlib

    import numpy as np

    from torchmpi_tpu_torch import serving

    tpg = importlib.import_module("torchmpi_tpu_torch.models.tp_generate")
    ppg = importlib.import_module("torchmpi_tpu_torch.models.pp_generate")
    oracle = importlib.import_module("torchmpi_tpu_torch.models.oracle")
    gen = importlib.import_module("torchmpi_tpu_torch.models.generate")
    ring = ops["ring"]
    t_phase = time.perf_counter()
    secs, t_mark = {}, [t_phase]

    def mark(name):
        now = time.perf_counter()
        secs[name] = now - t_mark[0]
        t_mark[0] = now

    H, L = LM["num_heads"], LM["max_len"]
    sharded = dict(tp=PSV_TP, num_heads=H, slot_tokens=L, backend="pallas")
    before = mpi.config()
    mpi.set_config(chunk_bytes=PSV_CHUNK_BYTES, pallas_bidirectional=False)
    params = tpg.init_tp_lm(torch.Generator(dev).manual_seed(SEED + 50),
                            vocab=LM["vocab"], embed=LM["embed"],
                            depth=LM["depth"], num_heads=H, device=dev)
    n_params = sum(t.numel() for t in mpi._tree.leaves(params))
    out = {"phase": "parallel_serving", "tp": PSV_TP,
           "replicas": PSV_REPLICAS, "slots": PSV_SLOTS, "slot_tokens": L,
           "params": n_params, "chunk_bytes": PSV_CHUNK_BYTES}

    # The burst: one replica, PSV_SLOTS requests admitted, then decode
    # steps at PSV_SLOTS live slots.
    make, sampled, _ = _serve_trace(np, serving, 1.0)
    srv = serving.Server.sharded(params, replicas=1, slots=PSV_SLOTS,
                                 **sharded)
    eng = srv.router.replicas[0]
    syncs = {}
    for i, r in enumerate(make()[:PSV_SLOTS]):
        r = serving.Request(f"b{i}", r.prompt, max_new=SERVE_BURST_STEPS + 8)
        if i == 1:
            syncs["prefill"] = count_host_syncs(torch, lambda: eng.admit(r))
        else:
            eng.admit(r)
    eng.step()
    syncs["decode_step"] = count_host_syncs(torch, eng.step)
    before_step = dict(ring.LAUNCHES)
    eng.step()
    step_launches = {k: v - before_step[k] for k, v in ring.LAUNCHES.items()
                     if v != before_step[k]}
    step_ms = []
    for _ in range(SERVE_BURST_STEPS):
        check(eng.active == PSV_SLOTS, "burst: a slot retired early")
        t = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - t) * 1e3)
    # By kernel on the eager step (a graph's kernels are the same).
    eng._step = eng._decode
    rows = profile_rows(torch, eng.step)
    ring_ms = sum(ms for k, _, ms in rows if "ring" in k)
    check(syncs == {"prefill": 1, "decode_step": 1},
          f"parallel_serving: host syncs {syncs}, want 1 a prefill and 1 a "
          f"decode step")
    unit_s = statistics.median(step_ms) / 1e3
    # An engine and its step's bound method form a cycle: only the
    # collector frees its stacks and pool.
    del srv, eng
    gc.collect()
    torch.cuda.empty_cache()
    D = LM["embed"]
    w_bytes = 4 * (LM["depth"] * 12 * D * D + D * LM["vocab"])
    cache_bytes = 2 * LM["depth"] * PSV_SLOTS * L * D * 4
    out["burst"] = {
        "step_ms": {"median": statistics.median(step_ms),
                    "min": min(step_ms), "max": max(step_ms)},
        "step_bound_ms": (w_bytes + cache_bytes) / PEAK_HBM_BYTES * 1e3,
        "step_bound_bytes": w_bytes + cache_bytes,
        "ring_launches_per_step": step_launches,
        "ring_device_ms_per_step": ring_ms,
        "step_device_ms": sum(ms for _, _, ms in rows),
        "top_kernels": [{"kernel": k[:90], "calls": c, "ms": ms}
                        for k, c, ms in rows[:8]],
        "host_syncs": syncs}
    mark("burst")

    # The main path: the trace over both replicas (a tick steps both), then
    # its first requests again with the bidirectional ring.
    make, sampled, gap_s = _serve_trace(np, serving, unit_s * PSV_REPLICAS)
    for mod in ops.values():
        mod.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9  # the tree, and earlier
    srv = serving.Server.sharded(params, replicas=PSV_REPLICAS,
                                 slots=PSV_SLOTS, **sharded)
    built_gb = torch.cuda.memory_allocated() / 1e9
    reqs = make()
    t = time.perf_counter()
    done = srv.run_trace(reqs)
    trace_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches_a = {n: c for n, c in ring.LAUNCHES.items() if c}
    st = srv.router.replicas[0]._stack  # replica tp0's stacks, for (a), (d)
    # (set_config re-plans everything: the rows are read first.)
    plan_rows = [d for d in mpi.planner.describe()
                 if d["kind"] == "serving"]
    mpi.set_config(pallas_bidirectional=True)
    srv_b = serving.Server.sharded(params, replicas=PSV_REPLICAS,
                                   slots=PSV_SLOTS, **sharded)
    reqs_b = make()[:PSV_BIDIR_REQUESTS]
    srv_b.run_trace(reqs_b)
    mpi.set_config(pallas_bidirectional=False)
    launches = {n: c for mod in ops.values()
                for n, c in mod.LAUNCHES.items() if c}
    vector = {n: c for n, c in ring.VECTOR_LAUNCHES.items() if c}
    check(len(done) == SERVE_REQUESTS and all(r.error is None for r in reqs),
          "parallel_serving: a request failed")
    served = {r.replica for r in reqs}
    check(served == {f"tp{i}" for i in range(PSV_REPLICAS)},
          f"parallel_serving: replicas that served: {served}")
    check(len(plan_rows) >= PSV_REPLICAS and all(
        d["topology"] == f"model={PSV_TP}" for d in plan_rows),
        f"parallel_serving: plan rows {plan_rows}")
    check(not any(k.startswith(("flash", "xent")) for k in launches),
          f"parallel_serving: a flash or xent kernel launched: {launches}")
    for k in PSV_PATH_KERNELS:
        check(launches.get(k, 0) > 0,
              f"parallel_serving: {k} launched no time: {launches}")
    plain = {r.rid: list(r.tokens) for r in reqs}
    s_ = srv.last_stats
    trace = {"tokens": s_["tokens"], "busy_s": s_["busy_s"],
             "tokens_per_s": s_["tokens"] / s_["busy_s"],
             "ttft_ms": {k: (v * 1e3 if isinstance(v, float) else v)
                         for k, v in _pcts([r.ttft_s for r in reqs]).items()},
             "itl_ms": {k: (v * 1e3 if isinstance(v, float) else v)
                        for k, v in _pcts(s_["itl_s"]).items()},
             "ticks": s_["ticks"], "wall_s": trace_s,
             "by_replica": {n: sum(r.replica == n for r in reqs)
                            for n in sorted(served)}}
    # The reckoning: each replica's stacks (the blocks and the head once,
    # the embedding table on every rank) and pool cache, against what the
    # build allocated (the rest is the captured graph's pool); the peak
    # also holds the caller's tree and what earlier phases keep.
    stack_b = 4 * (n_params + (PSV_TP - 1) * LM["vocab"] * D)
    mem = {"peak_gb": peak_gb, "before_build_gb": base_gb,
           "after_build_gb": built_gb,
           "replicas_gb": built_gb - base_gb,
           "replicas_reckoned_gb": PSV_REPLICAS * (stack_b + cache_bytes)
           / 1e9,
           "peak_over_build_gb": peak_gb - built_gb,
           "tree_gb": 4 * n_params / 1e9, "replica_stacks_gb": stack_b / 1e9,
           "replica_pool_gb": cache_bytes / 1e9}
    out.update(trace=trace, memory=mem, launches=launches,
               launches_default_config=launches_a, vector_launches=vector,
               unit_seconds=unit_s, mean_gap_s=gap_s)
    mark("trace")

    # (a) The TP logits (the decode path over a whole stream at once)
    # against the oracle's, then every greedy stream against the oracle
    # and against offline tp_generate, by the margin rule.
    greedy = [r for r in reqs if r.temperature is None]
    a_rows, a_err, a_ref = [], 0.0, 0.0
    with mpi.communicator("tp0"):
        for r in greedy[:SERVE_CHECKED]:
            seq = torch.as_tensor(np.concatenate(
                [r.prompt, r.tokens[:-1]]), device=dev)
            cache = st.zero_cache(1, seq.numel())
            x = st.decode(cache, seq[None],
                          torch.zeros(1, dtype=torch.long, device=dev))
            got = st.logits(x[:, 0])[r.prompt.size - 1:]
            ref = oracle.dense_logits(params, seq[None], H)[
                0, r.prompt.size - 1:]
            err, top = float((got - ref).abs().max()), float(
                ref.abs().max())
            a_rows.append({"rid": r.rid, "max_abs_err": err,
                           "max_abs_ref": top})
            a_err, a_ref = max(a_err, err), max(a_ref, top)
            del cache, x, got, ref
    check(a_err <= SERVE_LOGIT_RTOL * a_ref,
          f"(a) TP logits {a_err} off the oracle's, > {SERVE_LOGIT_RTOL} x "
          f"{a_ref}")
    greedy_b = [r for r in reqs_b if r.temperature is None]
    a_oracle = _ps_oracle_check(torch, oracle, params, greedy + greedy_b,
                                a_err)
    check(not any(m["above_err"] for m in a_oracle),
          f"(a) greedy streams differ from the oracle: {a_oracle}")
    mark("a oracle")
    offline = {}
    with mpi.communicator("tp0"):
        stacks = tpg.shard_tp_lm_rank_major(params, PSV_TP, "model")
        for r in greedy:
            offline[r.rid] = tpg.tp_generate_rank_major(
                params, r.prompt[None], r.max_new, axis="model",
                num_heads=H, backend="pallas", sharded=stacks)[
                0, r.prompt.size:].tolist()
        del stacks
    a_offline = _ps_judge(
        torch, lambda q: oracle.dense_logits(params, q[None], H)[0],
        greedy, offline, a_err)
    check(not any(m["above_err"] for m in a_offline),
          f"(a) greedy streams differ from offline tp_generate: "
          f"{a_offline}")
    out["a"] = {"logits_max_abs_err": a_err, "logits_max_abs_ref": a_ref,
                "logits_rel_err": a_err / a_ref, "requests": a_rows,
                "greedy_streams": len(greedy) + len(greedy_b),
                "oracle_differences": a_oracle,
                "offline_differences": a_offline}
    del srv, srv_b
    gc.collect()
    torch.cuda.empty_cache()
    mark("a offline")

    # The sampled streams on 4 slots of one replica in reversed arrival
    # order; speculation; a prefix-cache hit: bitwise.
    rs = [r for r in make() if r.temperature is not None][
        :PSV_SAMPLED_CHECKED]
    arr = [r.arrival_s for r in rs]
    for r, a in zip(rs, arr[::-1]):
        r.arrival_s = a
    serving.Server.sharded(params, replicas=1, slots=4, **sharded
                           ).run_trace(rs)
    layout_diff = [r.rid for r in rs if r.tokens != plain[r.rid]]
    check(not layout_diff,
          f"sampled streams differ on 4 slots: {layout_diff}")
    srv_e = serving.Server.sharded(params, replicas=PSV_REPLICAS,
                                   slots=PSV_SLOTS, spec_k=SERVE_SPEC_K,
                                   **sharded)
    e_reqs = make()[:PSV_SPEC_REQUESTS]
    srv_e.run_trace(e_reqs)
    e_diff = [r.rid for r in e_reqs if r.tokens != plain[r.rid]]
    e_stats = [dict(e.stats) for e in srv_e.router.replicas]
    check(not e_diff, f"speculative streams differ: {e_diff}")
    del srv_e
    rng = np.random.RandomState(SEED + 5)
    shared = rng.randint(0, LM["vocab"], size=SERVE_PREFIX)
    r2 = np.random.RandomState(SEED + 6)
    tails = [r2.randint(0, LM["vocab"], size=SERVE_TAIL)
             for _ in range(SERVE_PREFIX_REQS)]
    streams, hits = [], 0
    for cap in (0, 64):
        srv_f = serving.Server.sharded(
            params, replicas=1, slots=4, prefix_cache=cap,
            prefix_block=SERVE_PREFIX_BLOCK, **sharded)
        f_reqs = [serving.Request(
            f"f{i}", np.concatenate([shared, tails[i]]), max_new=32,
            arrival_s=0.0,
            **(dict(SERVE_SAMPLING, seed=7 + i) if i % 2 else {}))
            for i in range(SERVE_PREFIX_REQS)]
        srv_f.run_trace(f_reqs)
        streams.append({r.rid: r.tokens for r in f_reqs})
        hits = srv_f.router.replicas[0].stats["prefix_hits"]
        del srv_f
    check(streams[0] == streams[1] and hits > 0,
          f"prefix hits {hits}; streams equal {streams[0] == streams[1]}")
    gc.collect()
    out.update(sampled_layouts_bitwise=not layout_diff,
               spec={"equal": not e_diff, "requests": PSV_SPEC_REQUESTS,
                     "stats": e_stats},
               prefix_hits=hits)
    torch.cuda.empty_cache()
    mark("layouts spec prefix")

    # (d) Every ring row the traces launched, against the plain ring on the
    # same stacks: a long and a short prefill and a decode step, under
    # each config.
    log = TapLog()
    restore = tap_rank_major_routes(torch, mpi, ring, log,
                                    ops=("allreduce_rank_major",))
    try:
        with mpi.communicator("tp0"):
            for bidir in (False, True):
                mpi.set_config(pallas_bidirectional=bidir)
                for T in (1000, 400, 200):
                    tok = torch.randint(0, LM["vocab"], (1, T), device=dev)
                    st.prefill(tok, T)
                cache = st.zero_cache(PSV_SLOTS, 64)
                st.decode(cache, torch.randint(0, LM["vocab"],
                                               (PSV_SLOTS, 1), device=dev),
                          torch.arange(PSV_SLOTS, device=dev))
                del cache
    finally:
        restore()
        mpi.set_config(pallas_bidirectional=False)
    tapped = sorted({r_ for e in log for r_ in e["rows"]})
    tap = {"calls": len(log), "bitwise": all(e["bitwise"] for e in log),
           "rows": tapped}
    check(tap["bitwise"] and set(launches_a) | set(launches) <= set(tapped),
          f"(d) ring launches vs the plain ring: {tap}")
    out["ring_tap"] = tap
    del log, st
    torch.cuda.empty_cache()
    mark("d")

    # (b) PP over 4 stages against the oracle.
    pp = PSV_PP
    prompt = np.random.RandomState(SEED + 51).randint(
        0, LM["vocab"], size=(pp["batch"], pp["prompt"]))
    with mpi.communicator("pp", shape={"pp": pp["stages"]}):
        stacks = ppg.shard_pp_lm_rank_major(params, pp["stages"], "pp")
        kw = dict(axis="pp", num_heads=H, sharded=stacks)
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks = ppg.pp_generate_rank_major(params, prompt, pp["steps"], **kw)
        torch.cuda.synchronize()
        pp_s = time.perf_counter() - t
        del stacks
    pp_reqs = [serving.Request(f"pp{b}", prompt[b], max_new=pp["steps"])
               for b in range(pp["batch"])]
    for b, r in enumerate(pp_reqs):
        r.tokens = toks[b, pp["prompt"]:].tolist()
    b_diff = _ps_oracle_check(torch, oracle, params, pp_reqs, a_err)
    check(not any(m["above_err"] for m in b_diff),
          f"(b) PP greedy streams differ from the oracle: {b_diff}")
    out["b_pp"] = dict(pp, seconds=pp_s,
                       ms_per_step=pp_s * 1e3 / pp["steps"],
                       ms_per_token=pp_s * 1e3 / (pp["steps"] * pp["batch"]),
                       ticks=pp["stages"] * (pp["prompt"] + pp["steps"]),
                       oracle_differences=b_diff)
    del params
    torch.cuda.empty_cache()
    mark("b")

    # (c) generate_parallel: the moe_ep model at float32 on dcn 2 x ici 2
    # (the batch over dcn), against each row decoded alone with all experts
    # local; the flagship with Ulysses attention over 4 ranks against its
    # single-device decode.  beam_search_parallel with one beam is greedy.
    gp = PSV_GP
    prompt = np.random.RandomState(SEED + 52).randint(
        0, LM["vocab"], size=(gp["batch"], gp["prompt"]))
    c = {}
    mpi.set_config(dcn_size=EP_GRID[0])
    try:
        n = EP_GRID[0] * EP_GRID[1]
        moe, _ = _ep_model(torch, mpi, dev, torch.float32)
        moe.eval()
        t = time.perf_counter()
        grid = gen.generate_parallel_rank_major(moe, prompt, gp["steps"],
                                                n=n, batch_axis="dcn")
        torch.cuda.synchronize()
        c["moe_seconds"] = time.perf_counter() - t
        beam1 = gen.beam_search_parallel_rank_major(
            moe, prompt, gp["steps"], n=n, beams=1, batch_axis="dcn")
        alone = _ep_model(torch, mpi, dev, torch.float32,
                          moe_experts_per_device=n * EP_LM[
                              "moe_experts_per_device"] // EP_GRID[0],
                          moe_axis_size=1)[0]
        alone.load_state_dict(moe.state_dict())
        alone.eval()
        del moe
        one = torch.cat([gen.generate_parallel(alone, prompt[b:b + 1],
                                               gp["steps"])
                         for b in range(gp["batch"])])
        rs = [serving.Request(f"m{b}", prompt[b], max_new=gp["steps"])
              for b in range(gp["batch"])]
        for b, r in enumerate(rs):
            r.tokens = grid[b, gp["prompt"]:].tolist()

        def alone_logits(q):
            with torch.no_grad(), _LocalAttention(alone):
                return alone(torch.as_tensor(q, device=dev)[None])[0]

        refs = {r.rid: one[b, gp["prompt"]:].tolist()
                for b, r in enumerate(rs)}
        c["moe_vs_alone"] = _ps_judge(torch, alone_logits, rs, refs, a_err)
        for b, r in enumerate(rs):
            r.tokens = beam1[b, gp["prompt"]:].tolist()
        c["moe_beam1_vs_greedy"] = _ps_judge(
            torch, alone_logits, rs,
            {r.rid: grid[b, gp["prompt"]:].tolist()
             for b, r in enumerate(rs)}, a_err)
        del alone, grid, one, beam1
        torch.cuda.empty_cache()
    finally:
        mpi.set_config(dcn_size=before.dcn_size)
    uly_cfg = dict(LM, num_kv_heads=H)
    g = torch.Generator(device=dev).manual_seed(SEED + 53)
    uly = mpi.models.TransformerLM(**uly_cfg, attn_impl="ulysses",
                                   seq_axis="ici", device=dev, generator=g)
    dense = mpi.models.TransformerLM(**uly_cfg, attn_impl="local",
                                     device=dev)
    dense.load_state_dict(uly.state_dict())
    uly.eval()
    dense.eval()
    mpi.set_config(dcn_size=1)
    try:
        t = time.perf_counter()
        grid = gen.generate_parallel_rank_major(uly, prompt, gp["steps"],
                                                n=PSV_TP)
        torch.cuda.synchronize()
        c["ulysses_seconds"] = time.perf_counter() - t
        beam1 = gen.beam_search_parallel_rank_major(uly, prompt, gp["steps"],
                                                    n=PSV_TP, beams=1)
        cache_heads = gen._Decoder(uly, 1, (1, PSV_TP)).cache.k[0].shape[2]
    finally:
        mpi.set_config(dcn_size=before.dcn_size)
    single = mpi.models.generate(dense, prompt, gp["steps"])

    def dense_logits(q):
        with torch.no_grad():
            return dense(torch.as_tensor(q, device=dev)[None])[0]

    rs = [serving.Request(f"u{b}", prompt[b], max_new=gp["steps"])
          for b in range(gp["batch"])]
    for b, r in enumerate(rs):
        r.tokens = grid[b, gp["prompt"]:].tolist()
    c["ulysses_vs_single"] = _ps_judge(
        torch, dense_logits, rs,
        {r.rid: single[b, gp["prompt"]:].tolist()
         for b, r in enumerate(rs)}, a_err)
    for b, r in enumerate(rs):
        r.tokens = beam1[b, gp["prompt"]:].tolist()
    c["ulysses_beam1_vs_greedy"] = _ps_judge(
        torch, dense_logits, rs,
        {r.rid: grid[b, gp["prompt"]:].tolist() for b, r in enumerate(rs)},
        a_err)
    c["ulysses_cache_heads_a_rank"] = int(cache_heads)
    del uly, dense, grid, beam1, single
    torch.cuda.empty_cache()
    out["c_generate_parallel"] = dict(gp, **c)
    for k in ("moe_vs_alone", "moe_beam1_vs_greedy", "ulysses_vs_single",
              "ulysses_beam1_vs_greedy"):
        check(not any(m["above_err"] for m in c[k]),
              f"(c) {k}: {c[k]}")
    check(c["ulysses_cache_heads_a_rank"] == H // PSV_TP,
          f"(c) the Ulysses cache holds {cache_heads} heads a rank")
    mark("c")

    # The examples, each raising on a miss of its JAX assertions.
    examples = []
    for name, argv in PSV_EXAMPLES:
        mod = importlib.import_module(f"torchmpi_tpu_torch.examples.{name}")
        t = time.perf_counter()
        res = mod.main(list(argv) + ["--device", dev.type])
        examples.append({"example": name, "argv": list(argv),
                         "seconds": time.perf_counter() - t,
                         **{k: res[k] for k in ("greedy", "beam", "loss",
                                                "ranks") if k in res}})
    out["examples"] = examples
    mark("examples")
    mpi.set_config(chunk_bytes=before.chunk_bytes,
                   pallas_bidirectional=before.pallas_bidirectional)
    out.update(seconds_by_part=secs, seconds=time.perf_counter() - t_phase)
    emit(out)
    return {k: v for k, v in launches.items() if k in PSV_PATH_KERNELS}


# The bf16 flash route (slice 25): rows 1, 1 res, 2 and 3 on bf16 q / k / v
# at the kernel phase's shape, the residual form on batch 1 of it.  Each
# kernel against its plain version within one bf16 ulp of the largest
# element (the kernel rounds P against each kv block's running max, the
# plain version against the row's final max), and bitwise on a repeat.
FLASH_BF16_RTOL = 2.0 ** -7
FLASH_BF16_ROWS = ("flash_fwd", "flash_fwd_residual", "flash_bwd_dq",
                   "flash_bwd_dkv")
# The telemetry slice (slice 25): obs_dp's steps a side of the bitwise
# check (a), its timed steps a side in turns (e), and the eager dispatches
# a side of the host-cost comparison, in turns.
OBS_STEPS = 2
OBS_TURNS = 8
OBS_HOST_CALLS = 200
OBS_HOST_TURNS = ("off", "metrics", "metrics", "off") * 2
# obs_serving: lm_serving's trace cut to its first 16 requests, its
# arrivals spaced by lm_serving's 16-slot decode step (PERF.md §5, 6.78
# ms, PR 24).
OBS_SERVE_REQUESTS = 16
OBS_SERVE_UNIT_S = 6.78e-3
# analysis_dp: obs_dp's flagship DP step checked under Config.analysis.
ANALYSIS_STEPS = 2
ANALYSIS_TURNS = 4
ANALYSIS_CHECKS = 5  # (a)'s freshly built steps a side, first calls in turns
ANALYSIS_STALE_SHARDS = 2  # the seeded C1 step's spec, for 2 of 4 ranks


def flash_bf16_phase(torch, flash, dev):
    """The repair of queue C note 30: the flash kernels on bf16 operands.
    The main path is the user's: ``flash_attention`` (plain and with
    residuals) and ``flash_attention_grad`` forward and backward on bf16
    q / k / v at the kernel phase's shape (the residual form at batch 1),
    every flash counter set to 0 just before and read just after; every
    launch must be on the bf16 route, and the outputs bf16 (they raised
    before).  Then each kernel (rows 1, 1 res, 2, 3) against its plain
    version within FLASH_BF16_RTOL x max |ref| and bitwise on a repeat,
    timed beside its bound at the bf16 dense tensor-core rate and PyTorch
    SDPA's bf16 time (the yardstick, never the port's)."""
    B, T, H, Hkv, D, W = (BATCH, SEQ, LM["num_heads"], LM["num_kv_heads"],
                          LM["head_dim"], LM["window"])
    g = torch.Generator(device=dev).manual_seed(SEED + 30)

    def mk(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    q, k, v, do = mk(B, T, H, D), mk(B, T, Hkv, D), mk(B, T, Hkv, D), \
        mk(B, T, H, D)
    q1, k1, v1 = (t[:1].contiguous() for t in (q, k, v))
    kw = dict(scale=1.0 / math.sqrt(D), causal=True, window=W)

    # The main path, through the public entry points.
    flash.reset_launches()
    o_api = flash.flash_attention(q, k, v, causal=True, window=W)
    res_api = flash.flash_attention(q1, k1, v1, causal=True, window=W,
                                    return_residuals=True)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    o_grad = flash.flash_attention_grad(*xs, causal=True, window=W)
    o_grad.backward(do)
    torch.cuda.synchronize()
    routes = {n: dict(flash.ROUTE_LAUNCHES[n]) for n in FLASH_BF16_ROWS}
    launches = {f"{n}[bf16]": routes[n]["bf16"] for n in FLASH_BF16_ROWS}
    dtypes = {"o": str(o_api.dtype), "o_grad": str(o_grad.dtype),
              "num": str(res_api[0].dtype),
              "grads": [str(x.grad.dtype) for x in xs]}
    api_finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (o_api, o_grad, res_api[0], *(x.grad
                                                           for x in xs)))
    del xs, o_grad, res_api

    # Each kernel against its plain version (launches not counted).
    o, lse = flash.flash_fwd(q, k, v, **kw)
    o2, lse2 = flash.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, **kw)
    r = flash.flash_fwd_residual(q1, k1, v1, **kw)
    r2 = flash.flash_fwd_residual(q1, k1, v1, **kw)
    r_ref = flash.flash_fwd_residual_plain(q1, k1, v1, **kw)
    dof = do.float()
    dvec = torch.einsum("bqhd,bqhd->bhq", dof, o.float()).contiguous()
    dq = flash.flash_bwd_dq(q, k, v, dof, lse, dvec, **kw)
    dq2 = flash.flash_bwd_dq(q, k, v, dof, lse, dvec, **kw)
    dq_ref = flash.flash_bwd_dq_plain(q, k, v, dof, lse, dvec, **kw)
    dk, dv = flash.flash_bwd_dkv(q, k, v, dof, lse, dvec, **kw)
    dk2, dv2 = flash.flash_bwd_dkv(q, k, v, dof, lse, dvec, **kw)
    dk_ref, dv_ref = flash.flash_bwd_dkv_plain(q, k, v, dof, lse, dvec,
                                               **kw)
    torch.cuda.synchronize()

    def rel(pairs):
        """max |err| and max |ref| over (got, ref) pairs, each held to
        FLASH_BF16_RTOL of its own max |ref|."""
        errs = [(max_err(a, b), float(b.float().abs().max()))
                for a, b in pairs]
        return (max(e for e, _ in errs), max(m for _, m in errs),
                all(e <= FLASH_BF16_RTOL * m for e, m in errs))

    errs = {
        "flash_fwd": rel([(o, o_ref), (lse, lse_ref)]),
        "flash_fwd_residual": rel(zip(r, r_ref)),
        "flash_bwd_dq": rel([(dq, dq_ref)]),
        "flash_bwd_dkv": rel([(dk, dk_ref), (dv, dv_ref)]),
    }
    bitwise = {
        "flash_fwd": torch.equal(o, o2) and torch.equal(lse, lse2),
        "flash_fwd_residual": all(torch.equal(a, b) for a, b in zip(r, r2)),
        "flash_bwd_dq": torch.equal(dq, dq2),
        "flash_bwd_dkv": torch.equal(dk, dk2) and torch.equal(dv, dv2),
    }
    del o2, lse2, r2, dq2, dk2, dv2, o_ref, lse_ref, r_ref, dq_ref, dk_ref
    del dv_ref
    pos = torch.arange(T, device=dev)
    live = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
    pairs = B * H * int(live.sum())
    nbytes = lambda *ts: sum(t.numel() * t.element_size()  # noqa: E731
                             for t in ts)
    work = {
        "flash_fwd": (4 * D * pairs, nbytes(q, k, v, o, lse)),
        "flash_fwd_residual": (4 * D * pairs // B,
                               nbytes(q1, k1, v1, *r)),
        "flash_bwd_dq": (6 * D * pairs, nbytes(q, k, v, dof, lse, dvec, dq)),
        "flash_bwd_dkv": (8 * D * pairs,
                          nbytes(q, k, v, dof, lse, dvec, dk, dv)),
    }
    runs = {
        "flash_fwd": (lambda: flash.flash_fwd(q, k, v, **kw),
                      lambda: flash.flash_fwd_plain(q, k, v, **kw)),
        "flash_fwd_residual": (
            lambda: flash.flash_fwd_residual(q1, k1, v1, **kw),
            lambda: flash.flash_fwd_residual_plain(q1, k1, v1, **kw)),
        "flash_bwd_dq": (
            lambda: flash.flash_bwd_dq(q, k, v, dof, lse, dvec, **kw),
            lambda: flash.flash_bwd_dq_plain(q, k, v, dof, lse, dvec, **kw)),
        "flash_bwd_dkv": (
            lambda: flash.flash_bwd_dkv(q, k, v, dof, lse, dvec, **kw),
            lambda: flash.flash_bwd_dkv_plain(q, k, v, dof, lse, dvec,
                                              **kw)),
    }
    # The yardstick: one bf16 SDPA call on the same inputs and mask, and
    # one autograd backward through it (dq, dk and dv together).
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))

    def sdpa(a=qt, b=kt, c=vt):
        return torch.nn.functional.scaled_dot_product_attention(
            a, b, c, attn_mask=live, scale=kw["scale"], enable_gqa=True)

    sdpa_out, do_t = sdpa(), do.transpose(1, 2)
    q1t, k1t, v1t = (t.transpose(1, 2) for t in (q1, k1, v1))
    library_ms = {"flash_fwd": time_ms(torch, torch.no_grad()(sdpa)),
                  "flash_fwd_residual": time_ms(torch, torch.no_grad()(
                      lambda: sdpa(q1t, k1t, v1t)))}
    library_ms["flash_bwd_dq"] = library_ms["flash_bwd_dkv"] = time_ms(
        torch, lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t,
                                           retain_graph=True))
    rows = []
    for name in FLASH_BF16_ROWS:
        flops, nb = work[name]
        t_op, t_b = flops / PEAK_BF16_FLOPS * 1e3, nb / PEAK_HBM_BYTES * 1e3
        err, ref_max, ok = errs[name]
        rows.append({
            "name": f"{name}[bf16]", "route": "cuda",
            "source": SOURCES[name][0], "replaces": SOURCES[name][1],
            "max_abs_err": err, "max_abs_ref": ref_max,
            "tolerance": f"{FLASH_BF16_RTOL} x max |ref| a tensor",
            "within_tolerance": ok, "bitwise_repeat": bitwise[name],
            "ms": time_ms(torch, runs[name][0]),
            "plain_ms": time_ms(torch, runs[name][1], iters=3, warmup=1),
            "bound_ms": max(t_op, t_b),
            "bound_by": "operations" if t_op >= t_b else "bytes",
            "library_ms": library_ms[name],
            "library_call": ("sdpa forward, bf16" if "fwd" in name else
                             "sdpa backward, bf16: dq + dk + dv together"),
            "flops": flops, "bytes": nb, "design": "bf16 mma.sync m16n8k16",
            "route_launches": routes[name]})
    del sdpa_out, qt, kt, vt
    emit({"phase": "flash_bf16", "shape": dict(B=B, T=T, H=H, Hkv=Hkv, D=D,
                                               window=W, dtype="bfloat16",
                                               residual_batch=1),
          "live_pairs": pairs, "launches": launches, "routes": routes,
          "dtypes": dtypes, "kernels": rows})
    check(api_finite, "flash_bf16: non-finite output of the bf16 API")
    check(dtypes == {"o": "torch.bfloat16", "o_grad": "torch.bfloat16",
                     "num": "torch.float32",
                     "grads": ["torch.bfloat16"] * 3},
          f"flash_bf16: output dtypes {dtypes}")
    for n in FLASH_BF16_ROWS:
        check(routes[n]["bf16"] > 0 and routes[n]["tf32x3"] == 0,
              f"flash_bf16: {n} routes {routes[n]}, want bf16 only")
    for row in rows:
        check(row["within_tolerance"], f"{row['name']} max_abs_err "
              f"{row['max_abs_err']} over {FLASH_BF16_RTOL} x max |ref|")
        check(row["bitwise_repeat"], f"{row['name']}: two calls differ")
    return rows, launches


def _tools(*argvs):
    """``python -m torchmpi_tpu_torch.obs.tool`` on each argument list,
    the processes run together: [(return code, stdout), ...]."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torchmpi_tpu_torch.obs.tool", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__))) for argv in argvs]
    outs = []
    try:
        for argv, p in zip(argvs, procs):
            out, err = p.communicate(timeout=300)
            if p.returncode not in (0, 1):
                raise RuntimeError(f"obs tool {argv[0]}: {err[-2000:]}")
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def obs_dp_phase(torch, mpi, ops, dev):
    """The telemetry slice's main path: the flagship's data-parallel step
    of RING_N ranks on the card through
    ``gradsync.data_parallel_step_rank_major`` under backend "pallas" (as
    ring_dp configures it: the fused loss, 59 buckets on row 8), with
    ``Config.obs`` "metrics", then "trace".  (a) OBS_STEPS steps with obs
    off and the same steps from the same weights and batch with "metrics":
    losses and synced gradients bitwise equal; (b) 0 host syncs a step
    with "metrics"; (c) the counters equal what ran (every kernel counter
    and the registry set to 0 just before the "metrics" steps, read just
    after): gradsync rounds = steps, buckets = 59 x steps,
    ``tm_collectives_total`` by op and backend = the ring counters'
    delta, one step build, the planner's hits and misses; (d) the dump
    parses with the tool's dump, prom and attribute (the attribution's
    ms / step printed beside (e)'s median); (e) step ms with "metrics"
    and "off", OBS_TURNS timed steps a side in turns (each after an
    untimed one, since a set_config re-plans), and host us an eager
    dispatch a side, in turns; one step under "trace" with its call
    sites; (f) one step under ``utils.tracing.trace`` whose Chrome trace
    names the flash, xent and ring kernels."""
    import shutil
    import tempfile

    from torchmpi_tpu_torch import obs, planner
    from torchmpi_tpu_torch.parallel import gradsync
    from torchmpi_tpu_torch.utils import tracing

    ring = ops["ring"]
    n = RING_N
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    model = mpi.models.TransformerLM(**LM, attn_impl="flash",
                                     dtype=torch.bfloat16, device=dev,
                                     generator=g)
    tok = torch.randint(0, LM["vocab"], (BATCH, SEQ), generator=g,
                        device=dev)
    params = list(model.parameters())
    init = [p.detach().clone() for p in params]
    opt = torch.optim.SGD(params, lr=LR)
    out_dir = tempfile.mkdtemp(prefix="obs_dp_")

    def loss_fn(m, t):
        return fused_lm_loss(torch, mpi, m, t)

    def restore():
        with torch.no_grad():
            for p, p0 in zip(params, init):
                p.copy_(p0)
        model.zero_grad(set_to_none=True)

    def steps(mode, k):
        mpi.set_config(obs=mode, obs_dir=out_dir)
        restore()
        step = gradsync.data_parallel_step_rank_major(
            model, opt, loss_fn, n, backend="pallas")
        losses = [step(tok) for _ in range(k)]
        torch.cuda.synchronize()
        return step, losses

    try:
        # (a) obs off, then the main path: the same steps with "metrics".
        _, loss_off = steps("off", OBS_STEPS)
        grad_off = [p.grad.clone() for p in params]
        mpi.set_config(obs="metrics", obs_dir=out_dir)
        obs.reset()
        for mod in ops.values():
            mod.reset_launches()
        plans0 = planner.stats()
        step, loss_on = steps("metrics", OBS_STEPS)
        launches = {nm: c for mod in ops.values()
                    for nm, c in mod.LAUNCHES.items()}
        plans = {k_: planner.stats()[k_] - plans0[k_]
                 for k_ in ("hits", "misses")}
        snap = obs.registry().snapshot()
        bitwise_loss = all(torch.equal(a, b) for a, b in zip(loss_off,
                                                               loss_on))
        bitwise_grad = all(torch.equal(p.grad, r) for p, r in zip(params,
                                                                   grad_off))
        del grad_off
        reg = obs.registry()
        ring_calls = {nm: c for nm, c in ring.LAUNCHES.items() if c}
        counters = {
            "gradsync_rounds": reg.counter_total("tm_gradsync_rounds_total"),
            "gradsync_buckets": reg.counter_total(
                "tm_gradsync_buckets_total"),
            "collectives_by_op_backend": {
                f"{r['labels']['op']}/{r['labels']['backend']}": r["value"]
                for r in snap if r["name"] == "tm_collectives_total"},
            "step_builds": reg.counter("tm_step_builds_total",
                                       label="data_parallel_step"),
            "plan_hits": reg.counter_total("tm_plan_hit_total"),
            "plan_misses": reg.counter_total("tm_plan_miss_total"),
        }
        # (b) host syncs of one more step with "metrics" (not counted).
        syncs = count_host_syncs(torch, lambda: step(tok))
        # (d) the dump, through the tool.
        paths = obs.dump(out_dir)
        (rc_d, dump_out), (rc_p, prom_out), (rc_a, attr_out) = _tools(
            ["dump", *paths], ["prom", paths[0]],
            ["attribute", out_dir, "--json"])
        tool_rc = {"dump": rc_d, "prom": rc_p, "attribute": rc_a}
        attr = json.loads(attr_out)
        attr_host = attr["hosts"][0]

        # (e) overhead: step ms in turns, each timed step after an
        # untimed one (the set_config's re-plan).
        step_ms = {"off": [], "metrics": []}
        for turn in range(OBS_TURNS):
            for mode in (("off", "metrics") if turn % 2 == 0
                         else ("metrics", "off")):
                mpi.set_config(obs=mode)
                step(tok)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(tok)
                torch.cuda.synchronize()
                step_ms[mode].append((time.perf_counter() - t0) * 1e3)
        x = torch.ones(n, 4096, device=dev)
        host_us = {"off": [], "metrics": []}
        for mode in OBS_HOST_TURNS:
            mpi.set_config(obs=mode)
            for _ in range(5):
                mpi.allreduce_rank_major(x, backend="pallas")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(OBS_HOST_CALLS):
                mpi.allreduce_rank_major(x, backend="pallas")
            host_us[mode].append((time.perf_counter() - t0) * 1e6
                                 / OBS_HOST_CALLS)
            torch.cuda.synchronize()
        # One step under "trace": each eager event names its call site.
        mpi.set_config(obs="trace")
        obs.reset()
        step(tok)
        torch.cuda.synchronize()
        eager = [e for e in obs.recorder().events() if e[2] == "eager"]
        sites = sorted({e[6].split("@", 1)[-1] for e in eager})
        traced_sites = bool(eager) and all(
            "@" in e[6] and "chip_smoke.py:" in e[6] for e in eager)
        # (f) one step under utils.tracing.trace.
        mpi.set_config(obs="off")
        trace_dir = os.path.join(out_dir, "trace")
        with tracing.trace(trace_dir):
            with tracing.annotate("obs_dp/step"):
                step(tok)
        trace_path = os.path.join(trace_dir, "trace.json")
        trace_mb = os.path.getsize(trace_path) / 1e6
        with open(trace_path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        named = {part: any(re.search(pat, nm) for nm in names)
                 for part, pat in (("flash", r"flash_\w*kernel"),
                                   ("xent", r"tmw::|tmx::|xent_"),
                                   ("ring", r"ring_direct"),
                                   ("range", r"^obs_dp/step$"))}
    finally:
        mpi.set_config(obs="off")
        obs.deactivate()
        obs.reset()
        shutil.rmtree(out_dir, ignore_errors=True)
    med = {m: statistics.median(v) for m, v in step_ms.items()}
    emit({"phase": "obs_dp", "ranks": n, "buckets": RING_BUCKETS,
          "steps": OBS_STEPS, "losses_off": [float(v) for v in loss_off],
          "losses_metrics": [float(v) for v in loss_on],
          "bitwise_losses": bitwise_loss, "bitwise_grads": bitwise_grad,
          "host_syncs_per_step": syncs, "counters": counters,
          "ring_launches": ring_calls, "planner": plans,
          "tool_rc": tool_rc, "dump_lines": len(dump_out.splitlines()),
          "prom_lines": len(prom_out.splitlines()),
          "attribution": {"steps": attr_host["steps"],
                          "step_ms": attr_host["step_ms"],
                          "shares": attr["aggregate"],
                          "notes": attr_host.get("notes", [])},
          "step_ms": step_ms, "median_step_ms": med,
          "overhead_pct": (med["metrics"] / med["off"] - 1) * 100,
          "host_us_per_dispatch": host_us,
          "median_host_us_per_dispatch": {
              m: statistics.median(v) for m, v in host_us.items()},
          "trace_mode": {"eager_events": len(eager), "call_sites": sites},
          "chrome_trace": {"mb": trace_mb, "names": named},
          "launches": launches})
    check(bitwise_loss and bitwise_grad, "obs_dp (a): obs metrics changed "
          "the losses or the synced gradients")
    check(syncs == 0, f"obs_dp (b): {syncs} host syncs a step")
    k = OBS_STEPS
    row8 = launches.get("ring_allreduce_chunked", 0)
    check(counters["gradsync_rounds"] == k, f"obs_dp (c) rounds {counters}")
    check(counters["gradsync_buckets"] == RING_BUCKETS * k,
          f"obs_dp (c) buckets {counters}")
    check(counters["collectives_by_op_backend"] == {"allreduce/pallas":
                                                    sum(ring_calls.values())}
          and row8 == RING_BUCKETS * k,
          f"obs_dp (c) collectives {counters} vs ring {ring_calls}")
    check(counters["step_builds"] == 1, f"obs_dp (c) builds {counters}")
    check(counters["plan_misses"] == plans["misses"] == 1
          and counters["plan_hits"] == plans["hits"] == k - 1,
          f"obs_dp (c) plans {counters} vs planner {plans}")
    for nm in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
               "xent_bwd_dx", "xent_bwd_dw", "ring_allreduce_chunked"):
        check(launches.get(nm, 0) > 0, f"obs_dp: {nm} never launched")
    check(tool_rc == {"dump": 0, "prom": 0, "attribute": 0},
          f"obs_dp (d) tool exit codes {tool_rc}")
    check(attr_host["steps"] >= 1, "obs_dp (d) no attribution window")
    check(traced_sites, f"obs_dp (e) trace-mode call sites {sites}")
    check(all(named.values()), f"obs_dp (f) chrome trace names {named}")
    return launches


def analysis_dp_phase(torch, mpi, ops, dev):
    """The trace-time analysis slice's main path: obs_dp's flagship DP step
    (RING_N ranks on the card through
    ``gradsync.data_parallel_step_rank_major``, backend "pallas", the fused
    loss, 59 buckets on row 8) built under ``Config(analysis="error")``.
    (a) The step's first call is its check (the static pass over the step
    and the loss, then the call under the recorder): no error and no
    warning; the info findings are printed.  The check's one-time cost is
    the median first call of ANALYSIS_CHECKS freshly built armed steps
    less that of as many built off (the off first call carries every
    other first-call cost: the plans after ``set_config``), built from
    the same weights in turns, with both sides' spread.  (b) ANALYSIS_STEPS steps armed and off
    from the same weights and batch: losses and synced gradients bitwise
    equal (every kernel counter set to 0 just before the armed steps and
    read just after).  (c) 0 host syncs in an armed replayed step.
    (d) Two seeded bad steps, each refused by ``AnalysisError`` before
    the offending collective launches: a loss with an allreduce under
    ``if runtime.rank() == 0:`` (D1), refused before the step's first
    call with every kernel counter unchanged; a ZeRO-1 update over a
    spec built for ANALYSIS_STALE_SHARDS ranks (C1), refused at its
    reduce-scatter leg's dispatch with the reduce-scatter rows unchanged.
    (e) Step ms armed and off, ANALYSIS_TURNS timed steps a side in turns
    (no claim)."""
    from torchmpi_tpu_torch import analysis
    from torchmpi_tpu_torch.parallel import gradsync
    from torchmpi_tpu_torch.parallel import zero as pzero

    ring = ops["ring"]
    n = RING_N
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    model = mpi.models.TransformerLM(**LM, attn_impl="flash",
                                     dtype=torch.bfloat16, device=dev,
                                     generator=g)
    tok = torch.randint(0, LM["vocab"], (BATCH, SEQ), generator=g,
                        device=dev)
    params = list(model.parameters())
    init = [p.detach().clone() for p in params]
    opt = torch.optim.SGD(params, lr=LR)

    def loss_fn(m, t):
        return fused_lm_loss(torch, mpi, m, t)

    def restore():
        with torch.no_grad():
            for p, p0 in zip(params, init):
                p.copy_(p0)
        model.zero_grad(set_to_none=True)

    def build(mode, fn=loss_fn):
        mpi.set_config(analysis=mode)
        restore()
        return gradsync.data_parallel_step_rank_major(
            model, opt, fn, n, backend="pallas")

    def counters():
        return {nm: c for mod in ops.values() for nm, c in
                mod.LAUNCHES.items()}

    try:
        # (b) off first, then (a) + (b): the armed steps, the first one
        # the check.
        step_off = build("off")
        loss_off = [step_off(tok) for _ in range(ANALYSIS_STEPS)]
        torch.cuda.synchronize()
        grad_off = [p.grad.clone() for p in params]
        analysis.reset_captured()
        step_on = build("error")
        for mod in ops.values():
            mod.reset_launches()
        loss_on = [step_on(tok)]
        findings = analysis.captured_findings()
        loss_on += [step_on(tok) for _ in range(ANALYSIS_STEPS - 1)]
        torch.cuda.synchronize()
        launches = {nm: c for nm, c in counters().items() if c}
        bitwise_loss = all(torch.equal(a, b) for a, b in zip(loss_off,
                                                               loss_on))
        bitwise_grad = all(torch.equal(p.grad, r)
                           for p, r in zip(params, grad_off))
        del grad_off
        loud = [f for f in findings if f.severity != "info"]
        infos = [str(f) for f in findings if f.severity == "info"]
        # (c) host syncs of an armed replayed step.
        syncs = count_host_syncs(torch, lambda: step_on(tok))

        # (d) the seeded bad steps.
        def d1_loss(m, t):
            if mpi.runtime.rank() == 0:
                mpi.allreduce_rank_major(t[None].float(), backend="pallas")
            return fused_lm_loss(torch, mpi, m, t)

        bad = build("error", d1_loss)
        before = counters()
        refused = {}
        try:
            bad(tok)
            refused["D1"] = None
        except analysis.AnalysisError as e:
            refused["D1"] = sorted({f.rule for f in e.findings})
        torch.cuda.synchronize()
        d1_unchanged = counters() == before
        good = pzero.flat_spec(params, n_shards=n)
        stale = pzero.flat_spec(params, n_shards=ANALYSIS_STALE_SHARDS)
        flats, _ = mpi.fusion.rank_major_buffers(good, n, device=dev)
        p_shards = torch.zeros(n, stale.shard, dtype=stale.dtype,
                               device=dev)
        tx = mpi.optim.sgd(LR)
        zero_step = analysis.wrap_step(
            lambda ps, fl: pzero.update3_rank_major(
                ps, fl, tx.init(ps), tx, spec=stale, backend="pallas"),
            label="zero1_stale_spec", mode="error")
        rs_rows = ("ring_reduce_scatter_chunked", "ring_reduce_scatter")
        before = {k: ring.LAUNCHES[k] for k in rs_rows}
        try:
            zero_step(p_shards, flats)
            refused["C1"] = None
        except analysis.AnalysisError as e:
            refused["C1"] = sorted({f.rule for f in e.findings})
        torch.cuda.synchronize()
        c1_unchanged = {k: ring.LAUNCHES[k] for k in rs_rows} == before
        del flats, p_shards

        # (e) step ms armed and off in turns (no set_config between: the
        # armed step's signature is seen, the off step has no wrapper).
        restore()
        step_ms = {"off": [], "error": []}
        for turn in range(ANALYSIS_TURNS):
            for mode in (("off", "error") if turn % 2 == 0
                         else ("error", "off")):
                fn = step_off if mode == "off" else step_on
                fn(tok)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(tok)
                torch.cuda.synchronize()
                step_ms[mode].append((time.perf_counter() - t0) * 1e3)

        # (a) the check's one-time cost: first calls of freshly built
        # steps, armed and off in turns.
        first_ms = {"off": [], "error": []}
        for turn in range(ANALYSIS_CHECKS):
            for mode in (("off", "error") if turn % 2 == 0
                         else ("error", "off")):
                fn = build(mode)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(tok)
                torch.cuda.synchronize()
                first_ms[mode].append((time.perf_counter() - t0) * 1e3)
    finally:
        mpi.set_config(analysis="off")
        analysis.reset_captured()
    med = {m: statistics.median(v) for m, v in step_ms.items()}
    first_med = {m: statistics.median(v) for m, v in first_ms.items()}
    emit({"phase": "analysis_dp", "ranks": n, "buckets": RING_BUCKETS,
          "steps": ANALYSIS_STEPS, "losses_off": [float(v) for v in loss_off],
          "losses_error": [float(v) for v in loss_on],
          "bitwise_losses": bitwise_loss, "bitwise_grads": bitwise_grad,
          "findings_loud": [str(f) for f in loud], "findings_info": infos,
          "first_call_ms": first_ms, "median_first_call_ms": first_med,
          "check_one_time_ms": first_med["error"] - first_med["off"],
          "first_call_spread_ms": {m: max(v) - min(v)
                                   for m, v in first_ms.items()},
          "host_syncs_armed_replay": syncs, "refused": refused,
          "d1_counters_unchanged": d1_unchanged,
          "c1_reduce_scatter_rows_unchanged": c1_unchanged,
          "step_ms": step_ms, "median_step_ms": med,
          "armed_over_off_pct": (med["error"] / med["off"] - 1) * 100,
          "launches": launches})
    check(not loud, f"analysis_dp (a): findings {loud}")
    check(bitwise_loss and bitwise_grad, "analysis_dp (b): the armed step "
          "changed the losses or the synced gradients")
    check(syncs == 0, f"analysis_dp (c): {syncs} host syncs a replayed step")
    check(refused == {"D1": ["D1"], "C1": ["C1"]} and d1_unchanged
          and c1_unchanged, f"analysis_dp (d): refused {refused}, counters "
          f"unchanged D1 {d1_unchanged} C1 {c1_unchanged}")
    for nm in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
               "xent_bwd_dx", "xent_bwd_dw", "ring_allreduce_chunked"):
        check(launches.get(nm, 0) > 0, f"analysis_dp: {nm} never launched")
    check(launches.get("ring_allreduce_chunked") == RING_BUCKETS
          * ANALYSIS_STEPS, f"analysis_dp: row 8 launches {launches}")
    return launches


def obs_serving_phase(torch, mpi, dev):
    """The serving telemetry on the card: lm_serving's flagship (float32,
    flash as trained) on one replica of SERVE_SLOTS slots, the first
    OBS_SERVE_REQUESTS requests of its trace under the wall clock, with
    ``Config.obs`` "metrics": requests = completed = 16, the tokens
    counter = the tokens emitted, and ``tool slo``'s TTFT and ITL p50 in
    the same log2 bucket as the phase's own wall-clock p50s."""
    import importlib
    import shutil
    import tempfile

    import numpy as np

    from torchmpi_tpu_torch import obs, serving

    tool = importlib.import_module("torchmpi_tpu_torch.obs.tool")
    out_dir = tempfile.mkdtemp(prefix="obs_serving_")
    model = mpi.models.TransformerLM(
        **LM, attn_impl="flash", device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED + 2))
    model.eval()
    mpi.models.generate(model, np.zeros((1, 16), np.int64), 4)  # warm-up
    torch.cuda.synchronize()
    make, _, _ = _serve_trace(np, serving, OBS_SERVE_UNIT_S)
    reqs = make()[:OBS_SERVE_REQUESTS]
    try:
        mpi.set_config(obs="metrics", obs_dir=out_dir)
        obs.reset()
        srv = serving.Server(model, replicas=1, slots=SERVE_SLOTS,
                             slot_tokens=LM["max_len"])
        t0 = time.perf_counter()
        done = srv.run_trace(reqs)
        wall_s = time.perf_counter() - t0
        reg = obs.registry()
        counts = {e: reg.counter_total(f"tm_serving_{e}_total")
                  for e in ("requests", "completed", "tokens")}
        emitted = sum(len(r.tokens) for r in reqs)
        hist = {r["name"]: r for r in reg.snapshot()
                if r["name"] in ("tm_serving_ttft_us", "tm_serving_itl_us")}
        paths = obs.dump(out_dir)
        (rc, slo_out), = _tools(["slo", paths[0]])
    finally:
        mpi.set_config(obs="off")
        obs.deactivate()
        obs.reset()
        shutil.rmtree(out_dir, ignore_errors=True)
    def p50(xs):
        """The order statistic the histogram's p50 reads: the first value
        at which half the count is reached."""
        xs = sorted(xs)
        return xs[max(0, math.ceil(0.5 * len(xs)) - 1)]

    own = {"ttft": p50([r.ttft_s * 1e6 for r in reqs]),
           "itl": p50([x * 1e6 for x in srv.last_stats["itl_s"]])}

    def bucket(us):
        return int(us).bit_length() - 1

    slo_p50 = {kind: tool._hist_percentile(
        hist[f"tm_serving_{kind}_us"]["buckets"],
        hist[f"tm_serving_{kind}_us"]["count"], 0.5)
        for kind in ("ttft", "itl")}
    same = {kind: bucket(slo_p50[kind]) - 1 == bucket(own[kind])
            for kind in ("ttft", "itl")}
    emit({"phase": "obs_serving", "requests": len(reqs),
          "wall_s": wall_s, "counters": counts, "tokens_emitted": emitted,
          "own_p50_us": own, "slo_p50_upper_edge_us": slo_p50,
          "same_log2_bucket": same, "slo_rc": rc,
          "slo": slo_out.splitlines()})
    check(len(done) == OBS_SERVE_REQUESTS and all(r.error is None
                                                  for r in reqs),
          "obs_serving: a request failed")
    check(counts["requests"] == counts["completed"] == OBS_SERVE_REQUESTS,
          f"obs_serving: counters {counts}")
    check(counts["tokens"] == emitted,
          f"obs_serving: tokens counter {counts['tokens']} vs {emitted}")
    check(rc == 0 and all(same.values()),
          f"obs_serving: slo p50 {slo_p50} vs the phase's {own}")


# The chaos slice (slice 26): the fault layer and the watchdog on the card.
# chaos_dp: obs_dp's DP step armed (faults "policy", watchdog "warn") for
# CHAOS_STEPS steps a side of the bitwise check and CHAOS_TURNS timed steps
# in turns; then the flagship's buckets synced staged, clean and under
# CHAOS_RULES (the port's chaos tool's --rule specs, site:kind:prob:
# max_hits; the first matching rule of a site wins on each arrival's one
# draw, so a corrupt fires where the draw lies in [drop prob, corrupt
# prob)), retries CHAOS_RETRIES, backoff CHAOS_BACKOFF_S, the first k
# buckets where all of them would take more than about CHAOS_STAGED_BUDGET_S
# s; then one staged call stalled under watchdog "break" at a deadline of
# CHAOS_WD_DEADLINE_S.  chaos_serving: obs_serving's flagship and trace on
# 2 replicas of 8 slots, replica1 killed at one of its steps and the
# arrivals s10 and s11 dropped at the door.  chaos_ps: downpour_ps's
# AlexNet, PS_WORKERS workers taking CHAOS_PS_STEPS steps in turns, drops
# at both PS legs, ps.response's arrival 1 (worker 1's first push wait)
# among them, so at least one push is retransmitted.
CHAOS_STEPS = 2
CHAOS_TURNS = 4
CHAOS_SEED = 26
CHAOS_RULES = ("host_staged.gather:drop:0.08:3",
               "host_staged.gather:corrupt:0.2:3",
               "host_staged.scatter:drop:0.08:3",
               "host_staged.scatter:corrupt:0.2:3")
CHAOS_RETRIES = 8
CHAOS_BACKOFF_S = 0.001
CHAOS_STAGED_BUDGET_S = 60.0
CHAOS_STAGED_RTOL = 1e-6  # staged (rank-order fold) vs row 8 (ring order)
CHAOS_WD_DEADLINE_S = 1.0
CHAOS_WD_ESCALATE = 2.5  # the JAX watchdog's escalation, x the deadline
CHAOS_SERVE_REPLICAS, CHAOS_SERVE_SLOTS = 2, 8
CHAOS_SHED_AFTER = 10  # serving.admit arrivals 10 and 11 (s10, s11) shed
CHAOS_PS_STEPS = 3
CHAOS_PS_RULES = ("ps.request:drop:0.3:3", "ps.response:drop:1:1:0:1",
                  "ps.response:drop:0.3:3")


def _chaos_plan(path, rules, seed=CHAOS_SEED):
    """A plan written by the port's chaos tool (in process): ``--rule``
    specs ``site:kind:prob:max_hits[:delay_s[:after]]``."""
    from torchmpi_tpu_torch.faults import tool as ftool

    argv = ["gen", "--out", path, "--seed", str(seed)]
    for r in rules:
        argv += ["--rule", r]
    check(ftool.main(argv) == 0, f"chaos tool gen {rules}")
    return path


def _predict_staged(plan, calls: int, retries: int) -> dict:
    """What FaultPlan.decide gives for ``calls`` staged exchanges on the
    host: a gather arrival an attempt, then a scatter arrival when the
    gather did not fire; a fired arrival is one failed attempt (a retry,
    or exhausted past ``retries``); a call with a failure that ends well
    is one survived."""
    injected, retry, exhausted, survived = {}, 0, 0, 0
    for _ in range(calls):
        failures = 0
        while True:
            fired = None
            for site in ("host_staged.gather", "host_staged.scatter"):
                d = plan.decide(site)
                if d is not None:
                    key = f"{site}/{d[0].kind}"
                    injected[key] = injected.get(key, 0) + 1
                    fired = d
                    break
            if fired is None:
                break
            failures += 1
            if failures <= retries:
                retry += 1
            else:
                exhausted += 1
                break
        survived += failures > 0
    return {"injected": injected, "retry": retry, "exhausted": exhausted,
            "survived": survived}


def chaos_dp_phase(torch, mpi, ops, dev):
    """The chaos slice's main path on the data-parallel step: obs_dp's
    flagship DP step of RING_N ranks (``data_parallel_step_rank_major``
    under backend "pallas", 59 buckets on row 8).  (a) CHAOS_STEPS steps
    with faults and the watchdog off and the same steps with faults
    "policy" and the watchdog "warn" (leases in a temporary directory):
    losses and synced gradients bitwise, 0 host syncs a step, step ms a
    side in turns (no claim), the lease on disk and ``obs.tool blame
    --live`` naming rank 0 with exit 0; the kernel counters set to 0 just
    before the armed steps and read just after.  (b) The same flagship's
    rank gradients, each bucket's rank-major stack synced staged
    (``allreduce_rank_major(staged=True)``, mean) clean and under a plan of
    the port's chaos tool (CHAOS_RULES): bitwise equal, the tm_fault_*
    counters equal to FaultPlan.decide's prediction on the host, both
    against row 8's sync of the same stacks (bitwise, else rel. L2 <=
    CHAOS_STAGED_RTOL: the host adds in rank order, the ring in ring
    order).  (c) A stall at one staged call under watchdog "break"
    (deadline CHAOS_WD_DEADLINE_S): CollectiveHangError between 1x and
    CHAOS_WD_ESCALATE x the deadline, ``blame --live`` naming the stalled
    site while it holds, and the next call, the plan disarmed, bitwise to
    (b)'s."""
    import contextlib
    import io
    import shutil
    import tempfile
    import threading

    from torchmpi_tpu_torch import obs
    from torchmpi_tpu_torch.faults import inject
    from torchmpi_tpu_torch.obs import tool as otool
    from torchmpi_tpu_torch.parallel import gradsync

    ring = ops["ring"]
    n = RING_N
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    model = mpi.models.TransformerLM(**LM, attn_impl="flash",
                                     dtype=torch.bfloat16, device=dev,
                                     generator=g)
    tok = torch.randint(0, LM["vocab"], (BATCH, SEQ), generator=g,
                        device=dev)
    params = list(model.parameters())
    init = [p.detach().clone() for p in params]
    opt = torch.optim.SGD(params, lr=LR)
    work = tempfile.mkdtemp(prefix="chaos_dp_")
    lease_dir = os.path.join(work, "leases")
    armed = dict(faults="policy", watchdog="warn", watchdog_dir=lease_dir)
    off = dict(faults="off", watchdog="off")

    def loss_fn(m, t):
        return fused_lm_loss(torch, mpi, m, t)

    def restore():
        with torch.no_grad():
            for p, p0 in zip(params, init):
                p.copy_(p0)
        model.zero_grad(set_to_none=True)

    def steps(cfg, k):
        mpi.set_config(**cfg)
        restore()
        step = gradsync.data_parallel_step_rank_major(
            model, opt, loss_fn, n, backend="pallas")
        losses = [step(tok) for _ in range(k)]
        torch.cuda.synchronize()
        return step, losses

    out = {"phase": "chaos_dp", "ranks": n, "buckets": RING_BUCKETS,
           "steps": CHAOS_STEPS}
    try:
        # (a) both off, then the main path armed: the same steps.
        _, loss_off = steps(off, CHAOS_STEPS)
        grad_off = [p.grad.clone() for p in params]
        for mod in ops.values():
            mod.reset_launches()
        step, loss_on = steps(armed, CHAOS_STEPS)
        launches = {nm: c for mod in ops.values()
                    for nm, c in mod.LAUNCHES.items()}
        bitwise_loss = all(torch.equal(a, b) for a, b in zip(loss_off,
                                                               loss_on))
        bitwise_grad = all(torch.equal(p.grad, r)
                           for p, r in zip(params, grad_off))
        del grad_off
        syncs = count_host_syncs(torch, lambda: step(tok))
        lease = os.path.join(lease_dir, "wd_lease_0.json")
        lease_exists = os.path.exists(lease)
        (rc_live, live_out), = _tools(["blame", "--live", lease_dir])
        step_ms = {"off": [], "armed": []}
        for turn in range(CHAOS_TURNS):
            for mode in (("off", "armed") if turn % 2 == 0
                         else ("armed", "off")):
                mpi.set_config(**(armed if mode == "armed" else off))
                step(tok)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(tok)
                torch.cuda.synchronize()
                step_ms[mode].append((time.perf_counter() - t0) * 1e3)
        mpi.set_config(**off)
        del step
        torch.cuda.empty_cache()
        out.update(losses_off=[float(v) for v in loss_off],
                   losses_armed=[float(v) for v in loss_on],
                   bitwise_losses=bitwise_loss, bitwise_grads=bitwise_grad,
                   host_syncs_per_step=syncs, lease_exists=lease_exists,
                   blame_live_rc=rc_live,
                   blame_live=live_out.splitlines(), step_ms=step_ms,
                   median_step_ms={m: statistics.median(v)
                                   for m, v in step_ms.items()},
                   launches=launches)

        # (b) the flagship's rank gradients, bucket by bucket, staged.
        restore()
        stacks = [torch.empty((n, *p.shape), device=dev) for p in params]
        for r in range(n):
            model.zero_grad(set_to_none=True)
            fused_lm_loss(torch, mpi, model, tok[r:r + 1]).backward()
            for st, p in zip(stacks, params):
                st[r].copy_(p.grad)
        model.zero_grad(set_to_none=True)
        spec = mpi.fusion.FusedSpec(params)
        bounds = [(grp, lo, hi) for grp in spec.groups
                  for lo, hi in grp.bounds]
        check(len(bounds) == RING_BUCKETS, f"buckets {len(bounds)}")

        def bucket(i):
            grp, lo, hi = bounds[i]
            return mpi.fusion.gather_bucket(stacks, grp, lo, hi,
                                            rank_major=True)

        def staged(i):
            return mpi.allreduce_rank_major(bucket(i), op="mean",
                                            staged=True)[0].clone()

        clean, t0 = [], time.perf_counter()
        for i in range(len(bounds)):
            clean.append(staged(i))
            # Leave room for the chaos pass of the same buckets.
            if time.perf_counter() - t0 > CHAOS_STAGED_BUDGET_S / 2.5:
                break
        clean_s = time.perf_counter() - t0
        k = len(clean)
        plan_path = _chaos_plan(os.path.join(work, "staged.json"),
                                CHAOS_RULES)
        mpi.set_config(faults=plan_path, fault_retries=CHAOS_RETRIES,
                       fault_backoff_s=CHAOS_BACKOFF_S, obs="metrics",
                       obs_dir=os.path.join(work, "obs"))
        obs.reset()
        t0 = time.perf_counter()
        chaos = [staged(i) for i in range(k)]
        chaos_s = time.perf_counter() - t0
        reg = obs.registry()
        counted = {"injected": {}, "retry": reg.counter_total(
            "tm_fault_retry_total"), "exhausted": reg.counter_total(
            "tm_fault_exhausted_total"), "survived": reg.counter_total(
            "tm_fault_survived_total")}
        for row in reg.snapshot():
            if row["name"] == "tm_fault_injected_total":
                key = f"{row['labels']['site']}/{row['labels']['kind']}"
                counted["injected"][key] = \
                    counted["injected"].get(key, 0) + row["value"]
        mpi.set_config(faults="off", obs="off")
        obs.deactivate()
        predicted = _predict_staged(inject.FaultPlan.load(plan_path), k,
                                    CHAOS_RETRIES)
        staged_bitwise = all(torch.equal(a, b) for a, b in zip(clean,
                                                                 chaos))
        del chaos
        for mod in ops.values():
            mod.reset_launches()
        ring_bitwise, ring_rel = True, 0.0
        for i in range(k):
            r8 = mpi.allreduce_rank_major(bucket(i), op="mean",
                                          backend="pallas")[0]
            ring_bitwise = ring_bitwise and torch.equal(r8, clean[i])
            ring_rel = max(ring_rel, float(
                (r8 - clean[i]).norm() / clean[i].norm().clamp_min(1e-30)))
        torch.cuda.synchronize()
        row8_compare = ring.LAUNCHES["ring_allreduce_chunked"]
        out.update(staged={
            "rules": list(CHAOS_RULES), "seed": CHAOS_SEED,
            "retries": CHAOS_RETRIES, "backoff_s": CHAOS_BACKOFF_S,
            "buckets_k": k, "bucket_elems_a_rank": [
                hi - lo for _, lo, hi in bounds[:k]][:3],
            "clean_s": clean_s, "chaos_s": chaos_s,
            "bitwise_chaos_vs_clean": staged_bitwise,
            "counters": counted, "predicted": predicted,
            "vs_row8": "bitwise" if ring_bitwise else "rel_l2",
            "vs_row8_max_rel_l2": ring_rel,
            "row8_compare_launches": row8_compare})

        # (c) a stall under watchdog "break".
        stall_path = _chaos_plan(os.path.join(work, "stall.json"),
                                 ("host_staged.gather:stall:1:1",))
        mpi.set_config(faults=stall_path, watchdog="break",
                       watchdog_deadline_s=CHAOS_WD_DEADLINE_S,
                       watchdog_poll_s=0.02, watchdog_dir=lease_dir)
        from torchmpi_tpu_torch import watchdog

        seen, done = {}, threading.Event()

        def poll():
            # Until the stall's own window (site host_staged.gather) is
            # flagged: the staged call's window begins first and may be
            # flagged a monitor tick earlier.
            while not done.is_set():
                me = watchdog.read_leases(lease_dir).get(0)
                if me and any(e["stalled"]
                              and e["site"] == "host_staged.gather"
                              for e in me["inflight"]):
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        seen["rc"] = otool.main(["blame", "--live",
                                                 lease_dir])
                    seen["out"] = buf.getvalue()
                    return
                time.sleep(0.01)

        th = threading.Thread(target=poll, daemon=True)
        th.start()
        hang = None
        t0 = time.perf_counter()
        try:
            staged(0)
        except watchdog.CollectiveHangError as e:
            hang = e
        hang_s = time.perf_counter() - t0
        done.set()
        th.join(10)
        wd_stats = watchdog.stats()
        mpi.set_config(faults="off", watchdog="off")
        after = staged(0)
        out.update(stall={
            "deadline_s": CHAOS_WD_DEADLINE_S, "raised": repr(hang),
            "site": getattr(hang, "site", None), "seconds": hang_s,
            "bound_s": [CHAOS_WD_DEADLINE_S,
                        CHAOS_WD_ESCALATE * CHAOS_WD_DEADLINE_S],
            "blame_live_rc": seen.get("rc"),
            "blame_live": seen.get("out", "").splitlines(),
            "watchdog_stats": wd_stats,
            "next_call_bitwise": torch.equal(after, clean[0])})
        del clean, stacks
    finally:
        mpi.set_config(faults="off", watchdog="off", obs="off")
        if "torchmpi_tpu_torch.obs" in sys.modules:
            obs.deactivate()
            obs.reset()
        shutil.rmtree(work, ignore_errors=True)
    emit(out)
    check(bitwise_loss and bitwise_grad, "chaos_dp (a): arming the fault "
          "layer and the watchdog changed the losses or the gradients")
    check(syncs == 0, f"chaos_dp (a): {syncs} host syncs a step")
    check(lease_exists and rc_live == 0 and "rank 0" in live_out,
          f"chaos_dp (a): lease {lease_exists}, blame --live {rc_live}: "
          f"{live_out}")
    for nm in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
               "xent_bwd_dx", "xent_bwd_dw", "ring_allreduce_chunked"):
        check(launches.get(nm, 0) > 0, f"chaos_dp: {nm} never launched")
    check(launches["ring_allreduce_chunked"] == RING_BUCKETS * CHAOS_STEPS,
          f"chaos_dp: row 8 launches {launches['ring_allreduce_chunked']}")
    st = out["staged"]
    check(st["bitwise_chaos_vs_clean"], "chaos_dp (b): the staged sync "
          "under the plan differs from the clean one")
    check(st["counters"] == st["predicted"], f"chaos_dp (b): counters "
          f"{st['counters']} vs FaultPlan.decide {st['predicted']}")
    check(sum(st["predicted"]["injected"].values()) > 0,
          "chaos_dp (b): the plan injected nothing")
    check(st["vs_row8"] == "bitwise"
          or st["vs_row8_max_rel_l2"] <= CHAOS_STAGED_RTOL,
          f"chaos_dp (b): staged vs row 8 rel. L2 {st['vs_row8_max_rel_l2']}")
    sl = out["stall"]
    check(sl["site"] == "host_staged.gather"
          and sl["bound_s"][0] <= sl["seconds"] <= sl["bound_s"][1],
          f"chaos_dp (c): {sl['raised']} after {sl['seconds']} s")
    check(sl["blame_live_rc"] == 1 and any(
        "STALLED" in ln and "host_staged.gather" in ln
        for ln in sl["blame_live"]), f"chaos_dp (c): blame --live "
        f"{sl['blame_live']}")
    check(sl["next_call_bitwise"], "chaos_dp (c): the call after the "
          "stall differs from (b)'s")
    return launches


# guard_dp: obs_dp's replicated DP step of the flagship at depth 2 (the
# fused loss, the buckets on row 8) with Config.guard armed.  (a) numeric
# skip_step against off; (b) a NaN written into one leaf of rank
# GD_POISON_RANK's gradient; (c) the wire guard on the staged buckets
# under GD_WIRE_RULES (a silent flip at the second call's gather and the
# third call's scatter); (d) run_guarded over GD_REWIND["steps"] steps with
# a one-shot poison, once of each kind: the output head scaled by
# GD_REWIND["head_scale"] (the logits scale with it: a finite loss spike,
# which only the detector's median / MAD rule catches), then NaN added to
# every parameter (its non-finite rule).  + 1e3 on every parameter (JAX's
# test adds 1e6 to its toy state) drives this model's loss to exactly 0.0
# (logits near 2e9, where float32 absorbs log V), which a spike detector
# cannot tell from progress.
GD_STEPS = 2
GD_TURNS = 4
GD_POISON_RANK = 2
GD_STAGED_BUDGET_S = 10.0
GD_STAGED_MIN, GD_STAGED_MAX = 3, 8
GD_WIRE_RULES = ("host_staged.gather:corrupt_silent:1:1:0:1",
                 "host_staged.scatter:corrupt_silent:1:1:0:2")
GD_REWIND = dict(steps=10, save_every=3, poison_step=7,
                 poisons=("head_scale", "nan"), head_scale=8.0, window=8,
                 threshold=6.0, min_history=3)


def _predict_wire(plan, calls: int, retries: int) -> dict:
    """What FaultPlan.decide schedules for ``calls`` staged exchanges under
    the wire guard: a fired gather arrival fails its digest before the
    scatter leg (the attempt ends), a fired scatter arrival fails its own;
    each failed attempt is one ``verify_failed`` and a retry, and an
    exchange with failures that ends clean is one ``healed``."""
    failed, healed = 0, 0
    for _ in range(calls):
        fails = 0
        while True:
            hit = (plan.decide("host_staged.gather") is not None
                   or plan.decide("host_staged.scatter") is not None)
            if not hit:
                break
            fails += 1
            check(fails <= retries, "guard_dp (c): the plan outlasts the "
                  "retries")
        failed += fails
        healed += fails > 0
    return {"verify_failed": failed, "healed": healed}


def guard_dp_phase(torch, mpi, ops, dev):
    """The guard slice's main path on the data-parallel step: obs_dp's
    flagship DP step of RING_N ranks at depth 2
    (``data_parallel_step_rank_major`` under backend "pallas", the fused
    loss, its buckets on row 8) with ``Config.guard`` armed.
    (a) GD_STEPS steps with the guard off and the same steps from the same
    weights with ``guard="numeric"`` (skip_step): losses and synced
    gradients bitwise, 0 host syncs in the armed step, the kernel counters
    set to 0 just before the armed steps and read just after; the
    tripwire's device ms on the step's synced stacks, and step ms a side in
    turns.  (b) A NaN written into one leaf of rank GD_POISON_RANK's
    gradient (a tensor hook): under skip_step the parameters bitwise
    unchanged, ``stats()["skipped_steps"] == 1`` and
    ``tm_guard_skipped_step_total == 1``; under "raise" the step raises
    ``NumericAnomalyError`` naming "gradsync" at its ``raise_pending``
    boundary; under a ``guard_norm_bound`` of half the clean step's norm a
    trip as well.  (c) The flagship's rank gradients bucket by bucket,
    staged (chaos_dp (b)'s calls, the first k within GD_STAGED_BUDGET_S)
    under GD_WIRE_RULES (at most GD_STAGED_MAX: the digests make the
    guarded pass ~18x the clean one): without the guard some bucket
    differs from the clean pass; with ``guard="wire"`` every bucket is
    bitwise the clean one and ``tm_guard_verify_failed`` / ``healed``
    equal what FaultPlan.decide schedules.  (d) ``guard.run_guarded`` for
    GD_REWIND["steps"] steps, a checkpoint every GD_REWIND["save_every"],
    a one-shot poison before step GD_REWIND["poison_step"], once the
    output head times GD_REWIND["head_scale"] (a finite spike: the
    detector's median / MAD rule, its deviation in MADs recorded) and
    once NaN added to every parameter (the non-finite rule): each run's
    info {rewinds 1, trip_steps [7], recovered_step 6}, one trip of its
    rule, a rewind record on the board, the config epoch and the
    planner's misses unchanged, the parameters and every step's loss
    bitwise to a clean run.  Every check raises."""
    import shutil
    import tempfile

    from torchmpi_tpu_torch import guard, obs, planner, runtime
    from torchmpi_tpu_torch.faults import inject, membership
    from torchmpi_tpu_torch.parallel import gradsync

    ring = ops["ring"]
    n = RING_N
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    model = mpi.models.TransformerLM(**LM_D2, attn_impl="flash",
                                     dtype=torch.bfloat16, device=dev,
                                     generator=g)
    tok = torch.randint(0, LM["vocab"], (BATCH, SEQ), generator=g,
                        device=dev)
    params = list(model.parameters())
    init = [p.detach().clone() for p in params]
    opt = torch.optim.SGD(params, lr=LR)
    work = tempfile.mkdtemp(prefix="guard_dp_")
    poison = {"on": False, "calls": 0, "handles": []}
    leaf = min(range(len(params)), key=lambda k: params[k].numel())

    def loss_fn(m, t):
        for h in poison["handles"]:
            h.remove()
        poison["handles"].clear()
        r = poison["calls"] % n
        poison["calls"] += 1
        if poison["on"] and r == GD_POISON_RANK:
            poison["handles"].append(params[leaf].register_hook(
                lambda gr: torch.full_like(gr, float("nan"))))
        return fused_lm_loss(torch, mpi, m, t)

    def restore():
        with torch.no_grad():
            for p, p0 in zip(params, init):
                p.copy_(p0)
        model.zero_grad(set_to_none=True)
        poison["calls"] = 0

    def make_step():
        return gradsync.data_parallel_step_rank_major(
            model, opt, loss_fn, n, backend="pallas")

    def steps(cfg, k):
        mpi.set_config(**cfg)
        restore()
        step = make_step()
        losses = [step(tok) for _ in range(k)]
        torch.cuda.synchronize()
        return step, losses

    off = dict(guard="off", guard_numeric_policy="skip_step",
               guard_norm_bound=0.0)
    numeric = dict(off, guard="numeric")
    out = {"phase": "guard_dp", "ranks": n, "depth": LM_D2["depth"],
           "steps": GD_STEPS}
    try:
        # (a) off, then the main path armed: the same steps.
        _, loss_off = steps(off, GD_STEPS)
        grad_off = [p.grad.clone() for p in params]
        for mod in ops.values():
            mod.reset_launches()
        step, loss_on = steps(numeric, GD_STEPS)
        launches = {nm: c for mod in ops.values()
                    for nm, c in mod.LAUNCHES.items()}
        bitwise_loss = all(torch.equal(a, b)
                           for a, b in zip(loss_off, loss_on))
        bitwise_grad = all(torch.equal(p.grad, r)
                           for p, r in zip(params, grad_off))
        clean_ss = float(sum(torch.square(r.float()).sum()
                             for r in grad_off))
        del grad_off
        syncs = count_host_syncs(torch, lambda: step(tok))
        trips_a = guard.stats()
        stacks = [p.grad.unsqueeze(0).repeat(n, *([1] * p.grad.dim()))
                  for p in params]
        trip_ms = time_ms(torch, lambda: guard.check_tree(
            stacks, site="gradsync", rows=True))
        # The whole armed sync of the same stacks (the tripwire included),
        # for the tripwire's share.
        sync_ms = time_ms(torch, lambda: mpi.parallel.gradsync
                          .synchronize_gradients_rank_major(
                              stacks, backend="pallas"), iters=5)
        del stacks
        guard.reset_stats()
        step_ms = {"off": [], "numeric": []}
        for turn in range(GD_TURNS):
            for mode in (("off", "numeric") if turn % 2 == 0
                         else ("numeric", "off")):
                mpi.set_config(**(numeric if mode == "numeric" else off))
                step = make_step()
                step(tok)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(tok)
                torch.cuda.synchronize()
                step_ms[mode].append((time.perf_counter() - t0) * 1e3)
        out.update(losses_off=[float(v) for v in loss_off],
                   losses_numeric=[float(v) for v in loss_on],
                   bitwise_losses=bitwise_loss,
                   bitwise_grads=bitwise_grad,
                   host_syncs_per_step=syncs, stats_after_a=trips_a,
                   tripwire_device_ms=trip_ms,
                   armed_sync_device_ms=sync_ms, step_ms=step_ms,
                   median_step_ms={m: statistics.median(v)
                                   for m, v in step_ms.items()},
                   clean_grad_norm=math.sqrt(clean_ss), launches=launches)

        # (b) a NaN in one rank's gradient.
        def poisoned(cfg):
            mpi.set_config(**cfg, obs="metrics",
                           obs_dir=os.path.join(work, "obs"))
            obs.reset()
            guard.reset_stats()
            restore()
            before = [p.detach().clone() for p in params]
            step = make_step()
            poison["on"] = cfg.get("guard_norm_bound", 0.0) == 0.0
            raised = None
            try:
                step(tok)
            except guard.NumericAnomalyError as e:
                raised = e
            finally:
                poison["on"] = False
                for h in poison["handles"]:
                    h.remove()
                poison["handles"].clear()
            torch.cuda.synchronize()
            st = guard.stats()
            reg = obs.registry()
            res = {"stats": st, "raised": None if raised is None else {
                       "site": raised.site, "stat": raised.stat},
                   "tm_guard_skipped_step_total": reg.counter_total(
                       "tm_guard_skipped_step_total"),
                   "tm_guard_numeric_tripped_total": reg.counter_total(
                       "tm_guard_numeric_tripped_total"),
                   "params_unchanged": all(torch.equal(p, b) for p, b
                                           in zip(params, before))}
            del before
            mpi.set_config(obs="off")
            obs.deactivate()
            return res

        bound = 0.5 * math.sqrt(clean_ss)
        out.update(nan_skip_step=poisoned(numeric),
                   nan_raise=poisoned(dict(numeric,
                                           guard_numeric_policy="raise")),
                   norm_bound=dict(poisoned(dict(numeric,
                                                 guard_norm_bound=bound)),
                                   bound=bound))
        mpi.set_config(**off)

        # (c) the wire guard on the staged buckets.
        restore()
        stacks = [torch.empty((n, *p.shape), device=dev) for p in params]
        for r in range(n):
            model.zero_grad(set_to_none=True)
            fused_lm_loss(torch, mpi, model, tok[r:r + 1]).backward()
            for st, p in zip(stacks, params):
                st[r].copy_(p.grad)
        model.zero_grad(set_to_none=True)
        spec = mpi.fusion.FusedSpec(params)
        bounds = [(grp, lo, hi) for grp in spec.groups
                  for lo, hi in grp.bounds]

        def staged(i):
            grp, lo, hi = bounds[i]
            return mpi.allreduce_rank_major(
                mpi.fusion.gather_bucket(stacks, grp, lo, hi,
                                         rank_major=True),
                op="mean", staged=True)[0].clone()

        clean, t0 = [], time.perf_counter()
        for i in range(min(len(bounds), GD_STAGED_MAX)):
            clean.append(staged(i))
            if len(clean) >= GD_STAGED_MIN and \
                    time.perf_counter() - t0 > GD_STAGED_BUDGET_S:
                break
        clean_s = time.perf_counter() - t0
        k = len(clean)
        plan_path = _chaos_plan(os.path.join(work, "wire.json"),
                                GD_WIRE_RULES)
        runs = {}
        for mode in ("off", "wire"):
            mpi.set_config(guard=mode, faults=plan_path,
                           fault_retries=CHAOS_RETRIES,
                           fault_backoff_s=CHAOS_BACKOFF_S, obs="metrics",
                           obs_dir=os.path.join(work, "obs"))
            obs.reset()
            t0 = time.perf_counter()
            got = [staged(i) for i in range(k)]
            secs = time.perf_counter() - t0
            reg = obs.registry()
            runs[mode] = {
                "seconds": secs,
                "bitwise_per_bucket": [torch.equal(a, b)
                                       for a, b in zip(got, clean)],
                "verify_failed": reg.counter_total(
                    "tm_guard_verify_failed_total"),
                "healed": reg.counter_total("tm_guard_healed_total"),
                "verified": reg.counter_total("tm_guard_verified_total")}
            del got
            mpi.set_config(faults="off", guard="off", obs="off")
            obs.deactivate()
        predicted = _predict_wire(inject.FaultPlan.load(plan_path), k,
                                  CHAOS_RETRIES)
        out.update(wire={"rules": list(GD_WIRE_RULES), "buckets_k": k,
                         "buckets": len(bounds), "clean_s": clean_s,
                         "runs": runs, "predicted": predicted})
        del clean, stacks

        # (d) the agreed rewind.
        rw = GD_REWIND
        mpi.set_config(guard="full")
        guard.reset_stats()
        restore()
        make_step()(tok)  # the plans of this config, built before the run
        torch.cuda.synchronize()
        epoch0 = runtime.config_epoch()
        misses0 = planner.stats()["misses"]

        def guarded(directory, poison):
            losses = {}
            armed = [poison is not None]
            step = make_step()

            def init_fn():
                restore()
                return {"params": params}

            def step_fn(state, i):
                if state["params"] is not params:
                    with torch.no_grad():
                        for p, v in zip(params, state["params"]):
                            p.copy_(v)
                if armed[0] and i == rw["poison_step"]:
                    armed[0] = False  # one-shot: the replay is clean
                    with torch.no_grad():
                        if poison == "nan":
                            for p in params:
                                p.add_(float("nan"))
                        else:
                            model.head.mul_(rw["head_scale"])
                loss = float(step(tok))
                losses[i] = loss
                return {"params": params}, loss

            det = guard.LossSpikeDetector(
                window=rw["window"], threshold=rw["threshold"],
                min_history=rw["min_history"])
            trips, update = [], det.update

            def traced(loss):
                hit = update(loss)
                if hit:
                    trips.append({"loss": float(loss),
                                  "mads": det.last_stat})
                return hit

            det.update = traced
            t0 = time.perf_counter()
            _, info = guard.run_guarded(
                init_fn, step_fn, steps=rw["steps"], directory=directory,
                save_every=rw["save_every"], detector=det)
            torch.cuda.synchronize()
            return info, losses, trips, time.perf_counter() - t0

        cinfo, losses_clean, ctrips, clean_rw_s = guarded(
            os.path.join(work, "clean"), None)
        clean_params = [p.detach().clone() for p in params]
        runs_rw = {}
        for kind in rw["poisons"]:
            rdir = os.path.join(work, f"rewind_{kind}")
            info, losses_rw, trips, rw_s = guarded(rdir, kind)
            records = membership.Board(os.path.join(rdir, "membership")
                                       ).rewind_records()
            runs_rw[kind] = {
                "info": info, "trips": trips,
                "records": [{k_: v for k_, v in r.items() if k_ != "ts"}
                            for r in records],
                "losses": [losses_rw[i] for i in sorted(losses_rw)],
                "bitwise_losses": losses_rw == losses_clean,
                "bitwise_params": all(torch.equal(a, b) for a, b
                                      in zip(clean_params, params)),
                "seconds": rw_s}
            shutil.rmtree(rdir, ignore_errors=True)
        epoch1, misses1 = runtime.config_epoch(), planner.stats()["misses"]
        out.update(rewind={
            **rw, "runs": runs_rw, "clean_info": cinfo,
            "clean_trips": ctrips,
            "epoch_unchanged": epoch1 == epoch0,
            "plan_misses_unchanged": misses1 == misses0,
            "losses_clean": [losses_clean[i] for i in sorted(losses_clean)],
            "clean_seconds": clean_rw_s, "stats": guard.stats()})
        del clean_params
    finally:
        for h in poison["handles"]:
            h.remove()
        mpi.set_config(guard="off", guard_numeric_policy="skip_step",
                       guard_norm_bound=0.0, faults="off", obs="off")
        if "torchmpi_tpu_torch.obs" in sys.modules:
            obs.deactivate()
            obs.reset()
        guard.reset_stats()
        shutil.rmtree(work, ignore_errors=True)
    emit(out)
    check(bitwise_loss and bitwise_grad, "guard_dp (a): the numeric guard "
          "changed the losses or the synced gradients")
    check(syncs == 0, f"guard_dp (a): {syncs} host syncs in a step")
    check(trips_a["numeric_trips"] == 0, f"guard_dp (a): {trips_a}")
    for nm in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
               "xent_bwd_dx", "xent_bwd_dw", "ring_allreduce_chunked"):
        check(launches.get(nm, 0) > 0, f"guard_dp: {nm} never launched")
    sk = out["nan_skip_step"]
    check(sk["params_unchanged"] and sk["stats"]["skipped_steps"] == 1
          and sk["tm_guard_skipped_step_total"] == 1
          and sk["raised"] is None, f"guard_dp (b) skip_step: {sk}")
    rs = out["nan_raise"]
    check(rs["raised"] is not None and rs["raised"]["site"] == "gradsync",
          f"guard_dp (b) raise: {rs}")
    nb = out["norm_bound"]
    check(nb["stats"]["numeric_trips"] == 1 and nb["params_unchanged"],
          f"guard_dp (b) norm bound: {nb}")
    wire = out["wire"]
    check(wire["buckets_k"] >= GD_STAGED_MIN, f"guard_dp (c): {wire}")
    check(not all(wire["runs"]["off"]["bitwise_per_bucket"]),
          "guard_dp (c): the silent corruption did not show without the "
          "guard")
    check(all(wire["runs"]["wire"]["bitwise_per_bucket"]),
          "guard_dp (c): the wire guard did not heal every bucket")
    check({"verify_failed": wire["runs"]["wire"]["verify_failed"],
           "healed": wire["runs"]["wire"]["healed"]} == wire["predicted"]
          and wire["predicted"]["verify_failed"] > 0,
          f"guard_dp (c): counters {wire['runs']['wire']} vs "
          f"FaultPlan.decide {wire['predicted']}")
    r = out["rewind"]
    check(r["clean_info"]["rewinds"] == 0 and not r["clean_trips"],
          f"guard_dp (d): the clean run tripped {r['clean_trips']}")
    for kind, run in r["runs"].items():
        check({k_: run["info"][k_] for k_ in ("rewinds", "trip_steps",
                                              "recovered_step")}
              == {"rewinds": 1, "trip_steps": [rw["poison_step"]],
                  "recovered_step": 6},
              f"guard_dp (d) {kind}: info {run['info']}")
        tr = run["trips"]
        # The finite spike must be the median / MAD rule's (a finite loss
        # past the threshold), the NaN the non-finite rule's.
        check(len(tr) == 1 and (
            math.isfinite(tr[0]["loss"]) and math.isfinite(tr[0]["mads"])
            and tr[0]["mads"] > rw["threshold"] if kind == "head_scale"
            else not math.isfinite(tr[0]["loss"])),
            f"guard_dp (d) {kind}: trips {tr}")
        check(len(run["records"]) == 1
              and run["records"][0]["step"] == rw["poison_step"],
              f"guard_dp (d) {kind}: rewind records {run['records']}")
        check(run["bitwise_losses"] and run["bitwise_params"],
              f"guard_dp (d) {kind}: the rewound run differs from the "
              f"clean run")
    check(r["epoch_unchanged"] and r["plan_misses_unchanged"],
          "guard_dp (d): the rewind moved the config epoch or re-planned")
    return launches


def chaos_serving_phase(torch, mpi, dev):
    """The serving layer's fault half on the card: obs_serving's flagship
    (float32, flash as trained) as one Server of CHAOS_SERVE_REPLICAS
    replicas of CHAOS_SERVE_SLOTS slots, obs_serving's 16 requests of
    lm_serving's trace on the virtual clock (work units x
    OBS_SERVE_UNIT_S, so both runs schedule alike).  A fault-free run
    records the order of the replica steps; the plan (the port's chaos
    tool) then kills replica1 at one of its steps before s10 arrives
    (``serving.replica`` fail) and drops s10 and s11 at the door
    (``serving.admit`` drop).  Checks: the dead replica is replica1 and
    its sessions complete on replica0; exactly s10 and s11 are shed with
    the typed reason; the shed and fault counters equal the plan's; every
    completed greedy stream equals offline ``generate`` by lm_serving's
    (b) rule (a difference only at a top-2 margin under SERVE_LOGIT_RTOL
    x max |logit|), every sampled stream not re-routed the fault-free
    run's (re-routed ones reported); TTFT and ITL p50 beside the
    fault-free run's, no claim."""
    import shutil
    import tempfile

    import numpy as np

    from torchmpi_tpu_torch import obs, serving

    work = tempfile.mkdtemp(prefix="chaos_serving_")
    model = mpi.models.TransformerLM(
        **LM, attn_impl="flash", device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED + 2))
    model.eval()
    mpi.models.generate(model, np.zeros((1, 16), np.int64), 4)  # warm-up
    torch.cuda.synchronize()
    make, sampled, _ = _serve_trace(np, serving, OBS_SERVE_UNIT_S)

    def run(record=None):
        reqs = make()[:OBS_SERVE_REQUESTS]
        srv = serving.Server(model, replicas=CHAOS_SERVE_REPLICAS,
                             slots=CHAOS_SERVE_SLOTS,
                             slot_tokens=LM["max_len"])
        if record is not None:
            for eng in srv.router.replicas:
                def stepped(_e=eng, _step=eng.step):
                    record["steps"].append(_e.name)
                    return _step()
                eng.step = stepped
            gate = srv._gate

            def gated(req, depth):
                record["gates"][req.rid] = len(record["steps"])
                return gate(req, depth)
            srv._gate = gated
        t0 = time.perf_counter()
        done = srv.run_trace(reqs, unit_seconds=OBS_SERVE_UNIT_S)
        return reqs, srv, done, time.perf_counter() - t0

    def lat(reqs, srv):
        return {"ttft_p50_s": _pcts([r.ttft_s for r in reqs
                                     if r.ttft_s is not None])["p50"],
                "itl_p50_s": _pcts(srv.last_stats["itl_s"])["p50"]}

    shed_rids = [f"s{CHAOS_SHED_AFTER}", f"s{CHAOS_SHED_AFTER + 1}"]
    try:
        record = {"steps": [], "gates": {}}
        ref_reqs, ref_srv, _, ref_wall = run(record)
        cut = record["gates"][shed_rids[0]]
        cands = [i for i, nm in enumerate(record["steps"][:cut])
                 if nm == "replica1"]
        check(len(cands) >= 2, f"chaos_serving: replica1 stepped "
              f"{len(cands)} times before {shed_rids[0]}")
        kill_at = cands[len(cands) // 2]
        plan = _chaos_plan(os.path.join(work, "serving.json"), (
            f"serving.replica:fail:1:1:0:{kill_at}",
            f"serving.admit:drop:1:2:0:{CHAOS_SHED_AFTER}"))
        mpi.set_config(faults=plan, obs="metrics",
                       obs_dir=os.path.join(work, "obs"))
        obs.reset()
        reqs, srv, done, wall = run()
        reg = obs.registry()
        counters = {
            "shed": reg.counter_total("tm_serving_shed_total"),
            "rerouted": reg.counter_total("tm_serving_rerouted_total"),
            "completed": reg.counter_total("tm_serving_completed_total"),
            "injected": {}}
        for row in reg.snapshot():
            if row["name"] == "tm_fault_injected_total":
                key = f"{row['labels']['site']}/{row['labels']['kind']}"
                counters["injected"][key] = \
                    counters["injected"].get(key, 0) + row["value"]
    finally:
        mpi.set_config(faults="off", obs="off")
        if "torchmpi_tpu_torch.obs" in sys.modules:
            obs.deactivate()
            obs.reset()
        shutil.rmtree(work, ignore_errors=True)
    dead = [e.name for e in srv.router.replicas if e.dead]
    shed = [r for r in done if r.shed]
    rerouted = [r for r in reqs if r.reroutes]
    completed = [r for r in reqs if not r.shed]
    by_rid = {r.rid: r for r in ref_reqs}
    idx = {r.rid: i for i, r in enumerate(reqs)}
    greedy = [r for r in completed if idx[r.rid] not in sampled]
    mism = []
    for r in greedy:
        off = mpi.models.generate(model, r.prompt[None], r.max_new)[
            0, r.prompt.size:].tolist()
        if r.tokens == off:
            continue
        j = next(i for i, (x, y) in enumerate(zip(r.tokens, off)) if x != y)
        with torch.no_grad(), _LocalAttention(model):
            seq = torch.as_tensor(np.concatenate([r.prompt, off[:j]]),
                                  device=dev)
            logits = model(seq[None])[0, -1].float()
        m = float(_top2_margin(torch, logits))
        err = SERVE_LOGIT_RTOL * float(logits.abs().max())
        mism.append({"rid": r.rid, "at": j, "margin": m, "err": err,
                     "rerouted": bool(r.reroutes), "above_err": m > err})
    samp = [r for r in completed if idx[r.rid] in sampled]
    samp_same = {r.rid: r.tokens == by_rid[r.rid].tokens for r in samp}
    emit({"phase": "chaos_serving", "requests": len(reqs),
          "replicas": CHAOS_SERVE_REPLICAS, "slots": CHAOS_SERVE_SLOTS,
          "clock": f"work units x {OBS_SERVE_UNIT_S} s",
          "kill_at_replica_step": kill_at, "replica1_steps_before_shed":
          len(cands), "dead": dead, "shed": [r.rid for r in shed],
          "shed_reasons": [r.error for r in shed],
          "rerouted": {r.rid: [r.reroutes, r.replica] for r in rerouted},
          "counters": counters, "greedy_checked": len(greedy),
          "greedy_mismatches": mism, "sampled_same_as_fault_free":
          samp_same, "fault_free": dict(lat(ref_reqs, ref_srv),
                                        wall_s=ref_wall),
          "chaos": dict(lat(reqs, srv), wall_s=wall)})
    check(dead == ["replica1"], f"chaos_serving: dead replicas {dead}")
    check(rerouted and all(r.replica == "replica0" and r.error is None
                           for r in rerouted),
          "chaos_serving: a session of the dead replica did not complete "
          "on replica0")
    check([r.rid for r in shed] == shed_rids and all(
        "serving.admit" in r.error and "injected drop" in r.error
        for r in shed), f"chaos_serving: shed {[r.rid for r in shed]}")
    check(len(done) == OBS_SERVE_REQUESTS and all(
        r.error is None for r in completed), "chaos_serving: a request "
        "did not complete")
    check(counters["shed"] == 2 and counters["injected"] == {
        "serving.admit/drop": 2, "serving.replica/fail": 1}
        and counters["rerouted"] == sum(r.reroutes for r in reqs)
        and counters["completed"] == len(completed),
        f"chaos_serving: counters {counters}")
    check(not any(m["above_err"] for m in mism),
          f"chaos_serving: greedy streams differ from generate: {mism}")
    check(all(samp_same[r.rid] for r in samp if not r.reroutes),
          f"chaos_serving: sampled streams differ: {samp_same}")


def chaos_ps_phase(torch, mpi, dev):
    """The parameter server under faults on the card: downpour_ps's AlexNet
    (PS_PARAMS floats, PS_SHARDS shards) and PS_WORKERS workers, each
    ``examples/alexnet_downpour.downpour_step`` (Adam, an axpy push at
    alpha 1 / PS_WORKERS, a fetch every PS_FETCH_EVERY steps adopted one
    later) on a seeded random batch on the card, CHAOS_PS_STEPS steps a
    worker in turns, each push waited, under drops at ``ps.request`` and
    ``ps.response`` (CHAOS_PS_RULES, the port's chaos tool).  Checks: every
    push is a ``_ResilientPSHandle`` and completes; each push's native
    enqueues (counted at ``PSClient._enqueue``) equal what FaultPlan.decide
    gives on the host for the same exchanges (a drop at ps.response
    re-applies the push: the JAX package's retransmit semantics, held to
    the JAX server on the CPU in tests/test_torch_faults.py); the center is
    bitwise the numpy float32 fold c += alpha * u of each push as many
    times as it was applied; one event wait a push and no other host
    sync."""
    import shutil
    import tempfile

    import numpy as np

    from torchmpi_tpu_torch import faults
    from torchmpi_tpu_torch.examples import common
    from torchmpi_tpu_torch.examples.alexnet_downpour import downpour_step
    from torchmpi_tpu_torch.faults import inject
    from torchmpi_tpu_torch.parallel import ps as psmod

    work = tempfile.mkdtemp(prefix="chaos_ps_")

    def make():
        return mpi.models.AlexNet(
            PS_CLASSES, dropout=0.0, image_size=PS_IMAGE, device=dev,
            generator=torch.Generator(dev).manual_seed(SEED + 51))

    params0 = common.params_tree(make())
    alpha = 1.0 / PS_WORKERS
    ps = mpi.parameterserver.init(params0, num_shards=PS_SHARDS)
    workers = []
    for w in range(PS_WORKERS):
        m = make()
        names, prm = zip(*m.named_parameters())
        tx = mpi.optim.adam(PS_LR)
        workers.append({"model": m, "names": names, "params": prm,
                        "tx": tx, "states": [tx.init(p.detach())
                                             for p in prm],
                        "fetch": None, "step": 0,
                        "gen": torch.Generator(dev).manual_seed(
                            SEED + 60 + w)})
    plan = _chaos_plan(os.path.join(work, "ps.json"), CHAOS_PS_RULES)
    enqueued = []
    waits = [0]
    orig_enqueue = psmod.PSClient._enqueue
    orig_sync = torch.cuda.Event.synchronize

    def counting_enqueue(self, flat, inout, rid, a):
        enqueued.append(rid)
        return orig_enqueue(self, flat, inout, rid, a)

    def counting_sync(self):
        waits[0] += 1
        return orig_sync(self)

    exchanges, pushes, per_push = [], [], []
    try:
        mpi.set_config(faults=plan, fault_retries=CHAOS_RETRIES,
                       fault_backoff_s=CHAOS_BACKOFF_S)
        psmod.PSClient._enqueue = counting_enqueue
        torch.cuda.Event.synchronize = counting_sync
        t0 = time.perf_counter()
        for _ in range(CHAOS_PS_STEPS):
            for wk in workers:
                x = torch.randn(PS_BATCH, 3, PS_IMAGE, PS_IMAGE, device=dev,
                                generator=wk["gen"])
                y = torch.randint(0, PS_CLASSES, (PS_BATCH,), device=dev,
                                  generator=wk["gen"])
                had = wk["fetch"] is not None
                starts = (not had) and wk["step"] % PS_FETCH_EVERY == 0
                n0, w0 = len(enqueued), waits[0]
                box = {}

                def one(_wk=wk, _x=x, _y=y):
                    _, push, ups, _wk["fetch"] = downpour_step(
                        _wk["model"], _wk["names"], _wk["params"], _wk["tx"],
                        _wk["states"], ps, _x, _y, alpha, _wk["fetch"],
                        _wk["step"], PS_FETCH_EVERY)
                    push.wait()
                    box.update(push=push, ups=ups)

                syncs = count_host_syncs(torch, one)
                wk["step"] += 1
                # The exchanges in their order: the push's enqueue, the
                # fetch adopted (its wait) or one started (its enqueue),
                # the push's wait.
                exchanges += [("enqueue", True)] + (
                    [("wait", False)] if had else
                    [("enqueue", False)] if starts else []) + [
                    ("wait", True)]
                pushes.append(_flat_host(torch, mpi, box["ups"]))
                per_push.append({
                    "resilient": isinstance(box["push"],
                                            psmod._ResilientPSHandle),
                    "done": box["push"].done,
                    "applied": sum(1 for rid in enqueued[n0:]
                                   if rid == psmod.RULES["axpy"]),
                    "event_waits": waits[0] - w0, "other_syncs": syncs})
        for wk in workers:
            if wk["fetch"] is not None:
                wk["fetch"].wait()
                exchanges.append(("wait", False))
        seconds = time.perf_counter() - t0
        arrivals = {s: faults.plan().arrivals(s) for s in
                    ("ps.request", "ps.response")}
    finally:
        psmod.PSClient._enqueue = orig_enqueue
        torch.cuda.Event.synchronize = orig_sync
        mpi.set_config(faults="off")
    # What the plan gives on the host for the same exchanges.
    # An enqueue: ps.request arrivals until one does not fire, which
    # enqueues.  A wait: a ps.response arrival; on a fire, a retransmit
    # (ps.request until one enqueues) and the next ps.response.
    fp = inject.FaultPlan.load(plan)
    predicted, fired = [], 0
    for kind, is_push in exchanges:
        apps, first = 0, kind == "wait"
        while True:
            if not first:
                if fp.decide("ps.request") is not None:
                    fired += 1
                    continue
                apps += 1
            if kind == "enqueue":
                break
            first = False
            if fp.decide("ps.response") is None:
                break
            fired += 1
        if is_push and kind == "enqueue":
            predicted.append(apps)
        elif is_push:
            predicted[-1] += apps
    applied = [p["applied"] for p in per_push]
    a = np.float32(alpha)
    want = _flat_host(torch, mpi, params0)
    for u, k in zip(pushes, applied):
        for _ in range(k):
            want = want + a * u
    got = _flat_host(torch, mpi, ps.receive().wait())
    ps.shutdown()
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "chaos_ps", "workers": PS_WORKERS, "shards": PS_SHARDS,
          "steps_a_worker": CHAOS_PS_STEPS, "rules": list(CHAOS_PS_RULES),
          "seed": CHAOS_SEED, "retries": CHAOS_RETRIES,
          "pushes": per_push, "predicted_applications": predicted,
          "predicted_drops": fired,
          "arrivals": arrivals, "seconds": seconds,
          "center_bitwise": _bits_equal(got, want)})
    check(all(p["resilient"] and p["done"] for p in per_push),
          "chaos_ps: a push did not complete through _ResilientPSHandle")
    check(applied == predicted, f"chaos_ps: applications {applied} vs "
          f"FaultPlan.decide {predicted}")
    check(fired > 0 and sum(applied) > len(applied),
          f"chaos_ps: no push retransmitted {applied} {arrivals}")
    check(_bits_equal(got, want), "chaos_ps: the center is not the float32 "
          "fold of the applied pushes")
    check(all(p["event_waits"] == 1 and p["other_syncs"] == 0
              for p in per_push), f"chaos_ps: host syncs {per_push}")



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
    dev = mpi.init(device="cuda")
    try:
        rows = kernel_phase(torch, flash, dev)
        # The repair of slice 25: rows 1, 1 res, 2 and 3 on bf16 operands,
        # through the public entry points.
        bf16_rows, bf16_launches = flash_bf16_phase(torch, flash, dev)
        rows += bf16_rows
        torch.cuda.empty_cache()
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
        # The main path of slice 25: the same DP step through
        # data_parallel_step_rank_major with the telemetry layer on
        # (rows 1-6 and 8), bitwise to it off, its counters against the
        # launches.
        obs_launches = obs_dp_phase(torch, mpi, dict(ops, ring=ring), dev)
        torch.cuda.empty_cache()
        # The main path of slice 30: the same DP step under
        # Config(analysis="error"), checked once and bitwise to it off; two
        # seeded bad steps refused before their collectives launch.
        an_launches = analysis_dp_phase(torch, mpi, dict(ops, ring=ring),
                                        dev)
        torch.cuda.empty_cache()
        # The main path of slice 26: the same DP step with the fault layer
        # and the watchdog armed, bitwise to them off; the buckets staged
        # under a chaos plan; a stalled staged call broken by the watchdog.
        chaos_launches = chaos_dp_phase(torch, mpi, dict(ops, ring=ring),
                                        dev)
        torch.cuda.empty_cache()
        # The main path of slice 28's guard: the same DP step at depth 2
        # with the numeric tripwire armed, bitwise to it off; a NaN skipped
        # or raised; the staged buckets healed by the wire guard; a loss
        # spike rewound in place.
        gd_launches = guard_dp_phase(torch, mpi, dict(ops, ring=ring), dev)
        torch.cuda.empty_cache()
        # The main path of slice 4: ZeRO-1 / ZeRO-3 of RING_N ranks on the
        # card, its reduce-scatters and all-gathers on the ring kernels.
        launches.update(zero_dp_phase(torch, mpi, dict(ops, ring=ring), dev,
                                      ring_sync_ms))
        torch.cuda.empty_cache()
        # The main path of slice 27: the same ZeRO-1 flagship through the
        # restart loop under a stall and a rotted checkpoint, recovered
        # bitwise; then its state through the sharded checkpoint.
        rz_launches = restart_zero_phase(torch, mpi, dict(ops, ring=ring),
                                         dev)
        torch.cuda.empty_cache()
        # The main path of slice 28: the same ZeRO-1 flagship at depth 1 as
        # an elastic gang of 4 members, shrunk to 3 by a dead member and
        # grown back, rows 9 and 10 at n = 3.
        ez_launches = elastic_zero_phase(torch, mpi, dict(ops, ring=ring),
                                         dev)
        torch.cuda.empty_cache()
        # The main path of slice 29: the same gang at depth 2 with the
        # hot-state tier armed: recovered from buddy RAM at the kill's step,
        # fallen to the disk on a rotted replica, a member drained onto a
        # spare.
        hz_launches = hotstate_zero_phase(torch, mpi, dict(ops, ring=ring),
                                          dev)
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
        # The main path of slice 20: the flagship's widths over one
        # sequence of 8192 tokens as 4 rank-major ranks, ring_flash (the
        # residual kernel a ring step) and ulysses_flash, the fused loss;
        # the example longcontext_lm to its bar.
        sp_row, sp_launches = longcontext_sp_phase(torch, mpi, ops, dev)
        rows.append(sp_row)
        torch.cuda.empty_cache()
        # The main path of slice 21: the flagship with its MLP an expert
        # layer over ici, rank-major on a dcn 2 x ici 2 grid (rows 1-6 at
        # full width); the layer alone against its per-token oracle; the
        # example moe_lm to its bar.
        ep_launches = moe_ep_phase(torch, mpi, ops, dev)
        torch.cuda.empty_cache()
        # The main path of slice 22: a stack of Megatron blocks at the
        # flagship's widths, rank-major on the N-D world pp 2 x dp 2 x tp 2
        # (rows 1-3, the f / g and dp allreduces on the ring rows); the
        # example megatron_pipeline to its bar.
        mg_launches, dev = megatron_3d_phase(torch, mpi,
                                             dict(ops, ring=ring), dev)
        torch.cuda.empty_cache()
        # The main path of slice 23: the flagship served by the
        # continuous-batching server over one dense replica (no kernel of
        # the table: rows 1-14 counted, 0 each).
        lm_serving_phase(torch, mpi, dict(ops, ring=ring), dev)
        torch.cuda.empty_cache()
        # Slice 25's serving telemetry on the card.
        obs_serving_phase(torch, mpi, dev)
        torch.cuda.empty_cache()
        # Slice 26's serving chaos: a replica killed, two arrivals shed.
        chaos_serving_phase(torch, mpi, dev)
        torch.cuda.empty_cache()
        # The main path of slice 24: the flagship's widths served by two
        # tensor-parallel replicas of 4 rank-major ranks (rows 11, 8, 12
        # and 7 on the sublayers' sums), PP decode, generate_parallel.
        ps_launches = parallel_serving_phase(torch, mpi,
                                             dict(ops, ring=ring), dev)
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
        # Slice 26's PS chaos: drops at both legs, the pushes retransmitted.
        chaos_ps_phase(torch, mpi, dev)
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
        return {**({earlier: launches[name]} if launches.get(name) else {}),
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
                   if auto_launches.get(name) else {}),
                **({"longcontext_sp": sp_launches[name]}
                   if sp_launches.get(name) else {}),
                **({"moe_ep": ep_launches[name]}
                   if ep_launches.get(name) else {}),
                **({"megatron_3d": mg_launches[name]}
                   if mg_launches.get(name) else {}),
                **({"parallel_serving": ps_launches[name]}
                   if ps_launches.get(name) else {}),
                **({"flash_bf16": bf16_launches[name]}
                   if bf16_launches.get(name) else {}),
                **({"obs_dp": obs_launches[name]}
                   if obs_launches.get(name) else {}),
                **({"analysis_dp": an_launches[name]}
                   if an_launches.get(name) else {}),
                **({"chaos_dp": chaos_launches[name]}
                   if chaos_launches.get(name) else {}),
                **({"restart_zero": rz_launches[name]}
                   if rz_launches.get(name) else {}),
                **({"guard_dp": gd_launches[name]}
                   if gd_launches.get(name) else {}),
                **({"elastic_zero": ez_launches[name]}
                   if ez_launches.get(name) else {}),
                **({"hotstate_zero": hz_launches[name]}
                   if hz_launches.get(name) else {})}

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
