#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (torchmpi_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

needs one CUDA card and the CUDA toolkit (nvcc), and nothing else of the
JAX package.  In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels from ops/csrc with nvcc (sm_90a, one compiler per
   source, in parallel) into build/torch_kernels/: fourteen kernels in
   eight sources;
3. kernel phases: at the flagship LM's attention shapes (B 4, T 2048, 16 q /
   4 kv heads, head_dim 128, causal, window 1024, float32) runs each flash
   kernel against its plain PyTorch version on the same seeded inputs, and
   times kernel, plain version and, for the forward, PyTorch's
   scaled_dot_product_attention with the same mask (the yardstick only);
   then, at the flagship's LM-head shapes (N 4 x 2047 tokens, E 2048,
   V 32768, bf16), the three fused linear + cross-entropy kernels the same
   way, each also run twice and required bitwise equal, and the dense
   two-call loss (bf16 x @ w, then cross_entropy; forward and backward) timed
   beside them as context only; then the four ring-allreduce kernels on 4
   ranks' float32 buffers on the card at the flagship's gradient bucket
   (8,249,691 elements a rank), each under the chunk_bytes /
   pallas_bidirectional config that maps the bucket onto it, bitwise
   against the plain ring and against a repeat call, plus a bfloat16 and an
   int32 pass at 300,001 elements; then the four ring reduce-scatter and
   all-gather kernels at the flagship's ZeRO shapes (4 ranks, the
   reduce-scatter of 486,731,776 float32 a rank, the all-gather of the
   121,682,944-element shards) under chunk_bytes 4 MiB (the streamed rows)
   and 512 MiB (the resident rows), the same way, with the stock
   rank-major routes timed beside them;
4. dense train phase (stage B): mpi.init() (NCCL, world of 1) and three
   data-parallel SGD steps (lr 0.02) of the flagship TransformerLM at full
   width and depth (embed 2048, depth 8, GQA 16/4, head_dim 128, T 2048,
   vocab 32768, window 1024, RoPE, bf16 compute, float32 parameters,
   batch 4) with attn_impl="flash" and the dense loss (f32 x @ head);
5. fused train phase (stage B', the main path of the first two slices):
   the same steps with the fused loss, fused_linear_cross_entropy(h.bf16,
   head.bf16, labels); every kernel's launch count must be > 0 and the loss
   finite and falling; in both train phases one more, untimed step counts
   the host-device synchronizations of a step, which must be 0;
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
   loss falling, 0 host syncs in a step, all four ring kernels launched;
8. ZeRO phase (the main path of the ZeRO slice): the flagship as ZeRO data
   parallelism of 4 ranks on the one card with Adam (lr 1e-3): the 4 ranks'
   gradients in one [4, 486,731,776] stack, 3 ZeRO-1 steps under the
   default config (rows 9 and 10), 1 under chunk_bytes 512 MiB (rows 13 and
   14), 2 ZeRO-3 steps (gather_params, then update3); every reduce-scatter
   and all-gather bitwise equal to the plain ring, the gathered ranks
   equal, each ZeRO-3 update equal to a ZeRO-1 update on the same stack,
   the first ZeRO-1 step within 1e-4 (rel. L2 of the updates) of a
   replicated Adam step from the same state (every step's gap reported),
   the loss falling, 0 host syncs in a step, all
   four kernels launched;
9. prints the kernels' summary line, then {"ok": true, "device": ...}.

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
# in bf16, so one bf16 rounding of the largest element.
XENT_STAT_RTOL = 1e-4
XENT_GRAD_RTOL = 2.0 ** -7
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
ZERO_LR = 1e-3  # Adam, as benchmarks/memory_bench.py :58
ZERO_RTOL = 1e-4  # ZeRO-1 vs replicated Adam: rel. L2 of the updates

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
        "torchmpi_tpu_torch/ops/csrc/ring_allreduce.cu",
        "torchmpi_tpu/ops/ring.py:534"),
    "ring_allreduce_chunked": ("torchmpi_tpu_torch/ops/csrc/ring_allreduce.cu",
                               "torchmpi_tpu/ops/ring.py:511"),
    "ring_allreduce": ("torchmpi_tpu_torch/ops/csrc/ring_allreduce.cu",
                       "torchmpi_tpu/ops/ring.py:265"),
    "ring_allreduce_bidir": ("torchmpi_tpu_torch/ops/csrc/ring_allreduce.cu",
                             "torchmpi_tpu/ops/ring.py:203"),
    "ring_reduce_scatter_chunked": ("torchmpi_tpu_torch/ops/csrc/ring_rs_ag.cu",
                                    "torchmpi_tpu/ops/ring.py:707"),
    "ring_all_gather_chunked": ("torchmpi_tpu_torch/ops/csrc/ring_rs_ag.cu",
                                "torchmpi_tpu/ops/ring.py:733"),
    "ring_reduce_scatter": ("torchmpi_tpu_torch/ops/csrc/ring_rs_ag.cu",
                            "torchmpi_tpu/ops/ring.py:310"),
    "ring_all_gather": ("torchmpi_tpu_torch/ops/csrc/ring_rs_ag.cu",
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
    """{"D<head_dim>", "<kernel name>" or "<kernel name><dtype>": "registers;
    spills"} per kernel instantiation, from nvcc's -Xptxas -v report."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(.*?)'", ln)
        if m:
            d = re.search(r"ILi(\d+)E", m.group(1))
            name = re.search(r"(?:flash|xent|ring)_\w*?kernel(I\w+?E)?",
                             m.group(1))
            key = f"D{d.group(1)}" if d else (name.group(0) if name
                                              else m.group(1))
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
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, **kw)
    dvec = torch.einsum("bqhd,bqhd->bhq", do, o).contiguous()
    dq = flash.flash_bwd_dq(q, k, v, do, lse, dvec, **kw)
    dq_ref = flash.flash_bwd_dq_plain(q, k, v, do, lse, dvec, **kw)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, dvec, **kw)
    dk_ref, dv_ref = flash.flash_bwd_dkv_plain(q, k, v, do, lse, dvec, **kw)
    torch.cuda.synchronize()

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
    # Yardstick for the forward: one PyTorch call on the same inputs and
    # mask (never used by the port).
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=live, scale=kw["scale"], enable_gqa=True)

    sdpa_err = max_err(sdpa().transpose(1, 2), o)

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
            "library_ms": (time_ms(torch, sdpa) if name == "flash_fwd"
                           else None),
            "flops": flops, "bytes": nb,
        }
        if lse_err is not None:
            row["lse_max_abs_err"] = lse_err
            row["sdpa_max_abs_err"] = sdpa_err
        rows.append(row)
    emit({"phase": "kernels", "shape": dict(B=B, T=T, H=H, Hkv=Hkv, D=D,
                                            window=W, dtype="float32"),
          "live_pairs": pairs, "launches_in_phase": dict(flash.LAUNCHES),
          "kernels": rows})
    for row in rows:
        check(row["max_abs_err"] <= row["tolerance"],
              f"{row['name']} max_abs_err {row['max_abs_err']} > "
              f"{row['tolerance']}")
    check(errs["flash_fwd"][2] <= KERNEL_RTOL * float(lse.abs().max()),
          "flash_fwd lse disagrees with the plain version")
    return rows


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
    emit({"phase": "xent_kernels", "shape": dict(N=N, E=E, V=V,
                                                 dtype="bfloat16",
                                                 bwd_chunk=xent.BWD_CHUNK),
          "launches_in_phase": dict(xent.LAUNCHES), "kernels": rows})

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


def lm_loss(torch, model, tok):
    """Stage B's dense loss: logits = x @ head, softmax cross-entropy of
    each next token, mean."""
    logits = model(tok)
    V = logits.shape[-1]
    return torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, V).float(), tok[:, 1:].reshape(-1))


def fused_lm_loss(torch, mpi, model, tok):
    """The fused loss of stage B' (bench.py :1706-1720): the final LayerNorm's
    output and the head, both in bf16, through the fused linear +
    cross-entropy kernels, mean over the next tokens."""
    h, head = model(tok, return_prehead=True)
    E = h.shape[-1]
    return mpi.ops.fused_linear_cross_entropy(
        h[:, :-1].reshape(-1, E).to(torch.bfloat16),
        head.to(torch.bfloat16), tok[:, 1:].reshape(-1)).mean()


LOSSES = {
    "dense": lambda torch, mpi, m, t: lm_loss(torch, m, t),
    "fused": fused_lm_loss,
}


def train_phase(torch, mpi, ops, dev, loss: str):
    """Three timed DP steps of the flagship with the ``loss`` of LOSSES;
    every kernel counter is set to 0 just before and read just after."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    model = mpi.models.TransformerLM(**LM, attn_impl="flash",
                                     dtype=torch.bfloat16, device=dev,
                                     generator=g)
    n_params = sum(p.numel() for p in model.parameters())
    tok = torch.randint(0, LM["vocab"], (BATCH, SEQ), generator=g,
                        device=dev)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    loss_fn = LOSSES[loss]
    step = mpi.nn.data_parallel_step(
        model, opt, lambda m, t: loss_fn(torch, mpi, m, t))
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
    med = statistics.median(step_ms)
    peak = torch.cuda.max_memory_allocated()
    # One more, untimed step: how often a step makes the host wait for the
    # card (each wait drains the queue of work the host had run ahead on).
    syncs = count_host_syncs(torch, lambda: step(tok))
    emit({"phase": "train", "loss": loss,
          "config": dict(LM, batch=BATCH, seq=SEQ, lr=LR, dtype="bfloat16"),
          "params": n_params, "losses": losses, "step_ms": step_ms,
          "median_step_ms": med,
          "tokens_per_s": BATCH * SEQ / (med / 1e3),
          "peak_mem_bytes": peak, "host_syncs_per_step": syncs,
          "launches": launches, "world_size": mpi.size(),
          "backend": mpi.runtime.backend_name()})
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(syncs == 0, f"{syncs} host-device synchronizations in a step")
    path = [n for n in launches if loss == "fused" or n.startswith("flash")]
    for name in path:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              f"{loss} train path")
    return model, tok, launches


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


def ring_padded_elems(ring, name, L, plan):
    """Elements per rank the row's kernel works on (its padding)."""
    n, tile = RING_N, ring._TILE
    if plan:
        sub, C = plan
        per_half = n * C * sub
        return 2 * per_half if "bidir" in name else per_half
    if "bidir" in name:
        return sum(-(-h // (n * tile)) * n * tile for h in (L // 2, L - L // 2))
    return -(-L // (n * tile)) * n * tile


def ring_kernel_phase(torch, ring, dev):
    """Rows 7, 8, 11 and 12: RING_N ranks rank-major on the card at the
    flagship's gradient bucket, float32, each with the config that maps the
    bucket onto it; each kernel against its plain version, bitwise, and
    bitwise on a repeat call; then a bfloat16 and an int32 pass at a small
    size."""
    n, L = RING_N, RING_BUCKET
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn(n, L, generator=g, device=dev)
    small = {dt: (torch.randn(n, RING_SMALL, generator=g, device=dev).to(dt)
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
        out, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        bitwise = torch.equal(out, ref) and torch.equal(out, again)
        err = max_err(out, ref)
        del out, again, ref
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
        # Bounds.  The function reads every rank's buffer once and writes
        # every rank's result once: 2 n L 4 bytes.  The ring schedule on
        # one card moves more: per rank of S padded bytes, the staging copy
        # 2 S, each of the n - 1 reduce steps 5 S / n (own chunk read, the
        # peer's slot written, the slot read, own chunk read and written),
        # each of the n - 1 gather steps 4 S / n.
        S = 4 * ring_padded_elems(ring, name, L, plan)
        fn_bytes = 2 * n * L * 4
        ring_bytes = n * S * (2 + 9 * (n - 1) / n)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "max_abs_err": err,
            "tolerance": 0.0, "bitwise": bitwise,
            "small_passes_bitwise": passes,
            "chunk_bytes": cb, "bidirectional": bidir,
            "plan": ({"sub_elems": plan[0], "C": plan[1]} if plan
                     else {"sub_elems": S // 4 // n, "C": 1}),
            "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
            "bound_ms": fn_bytes / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes",
            "bytes": fn_bytes, "schedule_bytes": ring_bytes,
            "schedule_bound_ms": ring_bytes / PEAK_HBM_BYTES * 1e3,
            # The stock rank-major route computes the same function: the
            # rank-axis sum, copied to every rank.
            "library_ms": time_ms(torch, lambda: x.sum(0).expand_as(x).clone()),
        })
    emit({"phase": "ring_kernels", "ranks": n, "elems_per_rank": L,
          "dtype": "float32", "small_elems_per_rank": RING_SMALL,
          "launches_in_phase": dict(ring.LAUNCHES), "kernels": rows})
    for row in rows:
        check(row["bitwise"], f"{row['name']}: kernel != plain or repeat")
        for dt, ok in row["small_passes_bitwise"].items():
            check(ok, f"{row['name']} {dt}: kernel != plain")
    return rows


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
            out, again = kern(), kern()
            torch.cuda.synchronize()
            repeat = torch.equal(out, again)
            del again
            ref = plain()
            bitwise = torch.equal(out, ref) and repeat
            err = max_err(out, ref)
            del ref
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
            # out; all-gather n L in, n n L out (4-byte elements).  The
            # schedule on one card moves more (ring_rs_ag.cu): per rank of
            # S input bytes the reduce-scatter's staging 2 S, n - 1 steps of
            # 5 S / n and the copy-out 2 S / n; the all-gather of an S-byte
            # shard 2 S plus 4 S a step.
            S = 4 * L
            if rs:
                fn_bytes = 4 * (n * L + L)
                sched_bytes = n * S * (2 + (5 * (n - 1) + 2) / n)
                library = lambda: x.view(n, n, -1).sum(0)  # noqa: E731
            else:
                fn_bytes = 4 * (n * L + n * n * L)
                sched_bytes = n * S * (2 + 4 * (n - 1))
                library = lambda: x.unsqueeze(0).expand(  # noqa: E731
                    n, n, L).clone()
            rows.append({
                "name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "max_abs_err": err,
                "tolerance": 0.0, "bitwise": bitwise,
                "all_gather_rows_equal": rows_equal,
                "small_passes_bitwise": passes, "chunk_bytes": cb,
                "elems_per_rank": L,
                "plan": dict(zip(("sub_elems", "C"), ring._slots(
                    L // n if rs else L, plan))),
                "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
                "bound_ms": fn_bytes / PEAK_HBM_BYTES * 1e3,
                "bound_by": "bytes", "bytes": fn_bytes,
                "schedule_bytes": sched_bytes,
                "schedule_bound_ms": sched_bytes / PEAK_HBM_BYTES * 1e3,
                # The stock rank-major route: the rank-axis sum of the
                # [rank, tile] view / a copy of the stack per rank.
                "library_ms": time_ms(torch, library),
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
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]

    def one_step():
        rank_grads()
        sync()
        sgd()

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
    return launches, {k: statistics.median(v) for k, v in sync_ms.items()}


def tap_rank_major_routes(torch, mpi, ring, log):
    """Wrap the selector's "pallas" routes of the rank-major reduce-scatter
    and all-gather for the checked steps of the ZeRO path: each call runs
    the route (the kernels) between two CUDA events, then the plain ring
    on the same input, and appends to ``log`` whether the two agree
    bitwise (and, for the all-gather, whether every rank's slice is the
    same).  Returns the function that restores the plain routes."""
    sel = mpi.selector

    def wrap(verb, route, plain):
        def tapped(xs, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = route(xs, **kw)
            end.record()
            entry = {"verb": verb, "events": (start, end),
                     "label": log.label,
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
                                 ring.ring_all_gather_plain)}
    for op, (verb, route, plain) in routes.items():
        sel.register(op, "pallas", wrap(verb, route, plain))

    def restore():
        for op, (_, route, _) in routes.items():
            sel.register(op, "pallas", route)
    return restore


class TapLog(list):
    label = ""


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
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    main = [e for e in log if e["label"] != "check"]
    leg_ms = {}
    for e in main:
        leg_ms.setdefault(e["label"], {}).setdefault(e["verb"], []).append(
            e["events"][0].elapsed_time(e["events"][1]))

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
          "host_syncs_per_step": syncs, "launches": launches,
          "check_launches": excluded})
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
    return launches


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
        rows += ring_kernel_phase(torch, ring, dev)
        rows += ring_rs_ag_kernel_phase(torch, ring, dev)
        model, _, _ = train_phase(torch, mpi, ops, dev, "dense")
        del model
        torch.cuda.empty_cache()
        # The main path of slices 1 and 2: stage B', the fused LM-head loss.
        model, tok, launches = train_phase(torch, mpi, ops, dev, "fused")
        consistency_phase(torch, mpi, model, tok, dev)
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
    finally:
        mpi.stop()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: dict(row, launches=launches[row["name"]])[k] for k in keys}
               for row in rows]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
