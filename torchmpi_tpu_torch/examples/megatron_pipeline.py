"""3D model parallelism on the N-D world: tensor-parallel transformer blocks
inside pipeline stages, replicated over a data axis,
``Config(mesh_shape={"pp": S, "dp": G, "tp": W})``.

The counterpart of the JAX package's ``examples/megatron_pipeline.py``:
every pipeline stage is a Megatron block (``parallel.tensor``: heads and
MLP sharded over ``tp``, one allreduce a sublayer), the stages ride a
``parallel.pipeline`` schedule over ``pp`` (``gpipe_apply``, or
``interleaved_apply`` with two virtual chunks a stage via ``--schedule
interleaved``), and each ``dp`` group trains on its own microbatch stream,
its gradients averaged over ``dp`` (``allreduce_in_axis(..., "dp",
op="mean")``).  The widths (H = tp, D = 8 tp, F = 16 tp, B 2, T 8, M = 2
S), the weights and data (numpy, from ``--seed``), the loss (the last
stage's squared error over a fixed regression target, summed over ``pp``
by the g allreduce and divided by the target's size), SGD and the bar (the
last loss below 0.2 of the first, on runs of 60 steps or more; shorter
runs report) are the JAX example's.

The synced gradient carries no factor: g's backward is the identity, so
each rank's gradient is that of one copy of its dp group's loss, and the
dp mean makes it the gradient of the mean over the groups (held against
a dense oracle in tests/test_torch_examples.py).

Run rank-major on one device (``--devices 8``: pp 2 x dp 1 x tp 4;
``--devices 8 --dp 2``: pp 2 x dp 2 x tp 2), or one rank a process:
  ``torchrun --nproc-per-node 8 -m
  torchmpi_tpu_torch.examples.megatron_pipeline --dp 2``
Started inside a runtime the caller owns, it pushes a communicator of
that shape for its duration instead.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch import weights
from torchmpi_tpu_torch.examples import common
from torchmpi_tpu_torch.parallel import pipeline as pp
from torchmpi_tpu_torch.parallel import tensor as tp

BAR = 0.2  # last < BAR * first (JAX :153)
KEYS = ("wq", "wk", "wv", "wo", "w1", "w2")


def dense_block(seed: int, D: int, F: int) -> Dict[str, np.ndarray]:
    """JAX's ``dense_block`` (:65-76), draw for draw (the products in
    float64, as numpy takes them, rounded to float32)."""
    r = np.random.RandomState(seed)
    s = 1.0 / np.sqrt(D)
    w = {"wq": r.randn(D, D).astype(np.float32) * s,
         "wk": r.randn(D, D).astype(np.float32) * s,
         "wv": r.randn(D, D).astype(np.float32) * s,
         "wo": r.randn(D, D).astype(np.float32) * s,
         "w1": r.randn(D, F).astype(np.float32) * s,
         "w2": r.randn(F, D).astype(np.float32) * (1.0 / np.sqrt(F))}
    return {k: v.astype(np.float32) for k, v in w.items()}


def staged_weights(blocks, S: int, n_tp: int, K: int = 1):
    """The blocks [L] as the pipeline's layout ``[S, V, K, n_tp, ...]``:
    chunk ``[d, v]`` holds logical chunk ``v S + d`` of ``K`` consecutive
    blocks, each block's weights in ``n_tp`` shards (column blocks, row
    blocks for ``wo`` / ``w2``)."""
    def shards(key, w):
        fn = tp.shard_rows if key in ("wo", "w2") else tp.shard_columns
        return np.stack([fn(w, None, n_tp, i) for i in range(n_tp)])

    L = len(blocks)
    out = {}
    for k in KEYS:
        stacked = np.stack([shards(k, b[k]) for b in blocks])  # [L, n_tp..]
        chunks = stacked.reshape(L // K, K, *stacked.shape[1:])
        out[k] = pp.interleave_stages(chunks, S)  # [S, V, K, n_tp, ...]
    return out


def rank_major_params(staged, n_dp: int, dev) -> Dict[str, torch.Tensor]:
    """Every rank's chunks as stacks ``[n, V, K, ...]``, rank ``(p, d, t)``
    of the (pp, dp, tp) grid row-major holding stage p's tp-shard t
    (replicated over dp)."""
    out = {}
    for k, v in staged.items():
        S, V, K, n_tp = v.shape[:4]
        w = np.moveaxis(v, 3, 1)                     # [S, n_tp, V, K, ...]
        w = np.broadcast_to(w[:, None], (S, n_dp) + w.shape[1:])
        out[k] = weights.from_numpy_tree(
            np.ascontiguousarray(w.reshape(S * n_dp * n_tp,
                                           *w.shape[3:])), dev)
    return out


def local_params(staged, p: int, t: int, dev) -> Dict[str, torch.Tensor]:
    """This process's chunks ``[V, K, ...]``: stage ``p``, tp shard
    ``t``."""
    return weights.from_numpy_tree(
        {k: np.ascontiguousarray(v[p, :, :, t]) for k, v in staged.items()},
        dev)


def make_stage_fn(num_heads: int, D: int, dev, *, rank_major: bool,
                  attn_impl: str = "dense", window=None, backend=None):
    """One tick of a stage: its chunk's ``K`` blocks in order, each a
    ``tp_transformer_block`` over "tp" (unit layer norms, as JAX's)."""
    ln = (torch.ones(D, device=dev), torch.zeros(D, device=dev))
    block = (tp.tp_transformer_block_rank_major if rank_major
             else tp.tp_transformer_block)
    kdim = 1 if rank_major else 0

    def stage_fn(params, x):
        # One unbind a leaf (its backward one stack of the K gradients),
        # not K selects (each a zero-filled gradient of the whole leaf).
        names = list(params)
        for ws in zip(*(params[k].unbind(kdim) for k in names)):
            p = dict(zip(names, ws), ln1=ln, ln2=ln)
            x = block(x, p, "tp", num_heads=num_heads, backend=backend,
                      attn_impl=attn_impl, window=window)
        return x

    return stage_fn


def make_train_step(stage_fn, S: int, *, schedule: str, lr: float,
                    rank_major: bool, backend=None):
    """``step(params, xs, ys) -> (loss, grads)``: the pipeline over "pp",
    the last stage's squared error summed over "pp" by g and divided by
    the target's size, its gradients averaged over "dp" (a ``dp/mean``
    profiler range), and SGD on ``params`` in place (JAX :99-127).
    Rank-major: ``params`` leaves ``[n, V, K, ...]``, ``xs`` / ``ys`` ``[n,
    M, B, T, D]``; the loss each rank's ``[n]``.  In the process world:
    this rank's ``[V, K, ...]`` and ``[M, B, T, D]``, the loss ``[1]``.
    ``step.apply(params, xs)`` is the pipeline's forward alone."""
    def apply(params, xs):
        if schedule == "interleaved":
            fn = pp.interleaved_apply_rank_major if rank_major \
                else pp.interleaved_apply
            return fn(stage_fn, params, xs, "pp", broadcast_out=False)
        fn = pp.gpipe_apply_rank_major if rank_major else pp.gpipe_apply
        strip = 1 if rank_major else 0  # gpipe's chunks: V = 1
        return fn(stage_fn, {k: v.select(strip, 0) for k, v in
                             params.items()}, xs, "pp", broadcast_out=False)

    def step(params, xs, ys):
        leaves = [params[k] for k in KEYS]
        for w in leaves:
            w.requires_grad_(True)
        out = apply(params, xs)
        # Each rank's squared error ([n], or [1] in the process world: the
        # same reduction, so a world of one has the rank-major bits).
        n = xs.shape[0] if rank_major else 1
        size = out[0].numel() if rank_major else out.numel()
        sq = ((out - ys) ** 2).reshape(n, -1).sum(1)
        if rank_major:
            last = (torch.arange(n, device=xs.device) // (n // S)) == S - 1
            err = torch.where(last, sq, torch.zeros_like(sq))
            loss = tp.g_allreduce_rank_major(err, "pp") / size
            grads = torch.autograd.grad(loss.sum(), leaves)
            with record_function("dp/mean"):
                grads = [mpi.allreduce_rank_major(
                    g, op="mean", backend=backend, axis_names="dp")
                    for g in grads]
            loss = mpi.allreduce_rank_major(loss.detach(), op="mean",
                                            axis_names="dp")
        else:
            last = sq.new_full((1,), mpi.collectives.axis_index("pp")
                               == S - 1, dtype=torch.bool)
            err = torch.where(last, sq, torch.zeros_like(sq))
            loss = tp.g_allreduce(err, "pp") / size
            grads = torch.autograd.grad(loss.sum(), leaves)
            with record_function("dp/mean"):
                grads = [mpi.allreduce_in_axis(g, "dp", op="mean",
                                               backend=backend)
                         for g in grads]
            loss = mpi.allreduce_in_axis(loss.detach(), "dp", op="mean")
        with torch.no_grad():
            for w, g in zip(leaves, grads):
                w.requires_grad_(False)
                w.sub_(lr * g)
        return loss, dict(zip(KEYS, grads))

    step.apply = apply
    return step


@contextlib.contextmanager
def _world(args, shape: Dict[str, int]):
    """The (pp, dp, tp) world for the run: ``init(Config(mesh_shape=...))``
    when no runtime is up (stopped at the end), else a pushed
    communicator of that shape over the caller's ranks."""
    if not mpi.is_initialized():
        dev = mpi.init(mpi.Config(mesh_shape=shape), device=args.device)
        try:
            yield dev
        finally:
            mpi.stop()
        return
    with mpi.communicator("megatron_pipeline", shape=shape):
        yield mpi.runtime.device()


def _shape(args) -> Dict[str, int]:
    n = args.devices or (mpi.size() if mpi.is_initialized() else None)
    if args.tp != -1 or n is None:
        return {"pp": args.pp, "dp": args.dp, "tp": args.tp}
    if n % (args.pp * args.dp):
        raise ValueError(f"pp {args.pp} x dp {args.dp} does not divide "
                         f"{n} ranks")
    return {"pp": args.pp, "dp": args.dp, "tp": n // (args.pp * args.dp)}


def main(argv=None):
    args = common.parse_args(
        __doc__, argv, defaults={"lr": 0.05, "steps": 120},
        schedule=dict(type=str, default="gpipe",
                      choices=["gpipe", "interleaved"]),
        pp=dict(type=int, default=2, help="pipeline stages"),
        dp=dict(type=int, default=1, help="data-parallel groups"),
        tp=dict(type=int, default=-1,
                help="tensor-parallel width (-1 = rest of the ranks)"))
    rank_major = bool(args.devices)
    with _world(args, _shape(args)) as dev:
        n = args.devices if rank_major else None
        shape = mpi.runtime.current_communicator().shape(n)
        if not rank_major and mpi.size() == 1:
            shape = {"pp": args.pp, "dp": args.dp, "tp": max(args.tp, 1)}
            if shape != {"pp": 1, "dp": 1, "tp": 1}:
                raise ValueError(f"a world of one process is pp 1 x dp 1 x "
                                 f"tp 1; use --devices for {shape}")
        S, n_dp, n_tp = shape["pp"], shape["dp"], shape["tp"]
        V = 2 if args.schedule == "interleaved" else 1
        L = S * V
        H, D, F, B, T, M = n_tp, 8 * n_tp, 16 * n_tp, 2, 8, 2 * S
        print(f"pp{S} x dp{n_dp} x tp{n_tp}"
              + (" rank-major" if rank_major else "")
              + f": {L} blocks, {args.schedule}")

        rng = np.random.RandomState(args.seed)
        blocks = [dense_block(args.seed + 1 + l, D, F) for l in range(L)]
        staged = staged_weights(blocks, S, n_tp)
        xs = rng.randn(n_dp, M, B, T, D).astype(np.float32)
        ys = (rng.randn(n_dp, M, B, T, D) * 0.3).astype(np.float32)
        if rank_major:
            params = rank_major_params(staged, n_dp, dev)
            rows = [d for _ in range(S) for d in range(n_dp)
                    for _ in range(n_tp)]
            xs_t = weights.from_numpy_tree(np.ascontiguousarray(xs[rows]),
                                           dev)
            ys_t = weights.from_numpy_tree(np.ascontiguousarray(ys[rows]),
                                           dev)
        else:
            ax = mpi.collectives.axis_index
            params = local_params(staged, ax("pp"), ax("tp"), dev)
            xs_t = weights.from_numpy_tree(xs[ax("dp")], dev)
            ys_t = weights.from_numpy_tree(ys[ax("dp")], dev)
        stage_fn = make_stage_fn(H, D, dev, rank_major=rank_major,
                                 backend=args.backend)
        step = make_train_step(stage_fn, S, schedule=args.schedule,
                               lr=args.lr, rank_major=rank_major,
                               backend=args.backend)
        losses = []
        for i in range(args.steps):
            loss, _ = step(params, xs_t, ys_t)
            losses.append(float(loss.reshape(-1)[0]))
            if i % 20 == 0 or i == args.steps - 1:
                print(f"step {i:4d}  loss {losses[-1]:.4f}")
    first, last = losses[0], losses[-1]
    drop = last / first
    print(f"loss {first:.4f} -> {last:.4f}  ({args.schedule}, pp{S} x "
          f"dp{n_dp} x tp{n_tp}, {L} blocks)")
    out = {"losses": losses, "first": first, "last": last, "drop": drop,
           "learned": drop < BAR}
    if args.steps >= common.FULL_RUN_STEPS and not out["learned"]:
        raise AssertionError(f"3D-parallel training did not converge: "
                             f"{drop:.3f}")
    return out


if __name__ == "__main__":
    main()
