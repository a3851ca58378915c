"""The N-D world across processes: 4 gloo processes, one run for the
module, on ``mesh_shape`` {"pp": 2, "tp": 2}, then {"dp": 2, "tp": 2},
then {"pp": 2, "dp": 2, "tp": 1}, then {"pp": 1, "dp": 4}.

Each process runs the process-world forms on its own rank's data and
holds each result against its slice of the rank-major form of all four
ranks' data, which it computes itself from the same seeded tensors:

- the per-axis groups and coordinates (``axis_index``, ``group``,
  ``world_shape``) and the in-axis verbs over one axis, two and all;
- a pushed communicator over ranks [0, 1] (ranks 2 and 3 push it too, as
  every process must, and are no members), and a pushed (a, b) grid: an
  identical re-push makes no group and no plan miss, a changed one
  replaces it;
- ``shift_in_axis_grad``, linear and around the ring, and its backward;
- ``tp_transformer_block`` over "tp" (dense and flash attention), and
  ``gpipe_apply`` / ``interleaved_apply`` of TP blocks over "pp":
  outputs and gradients;
- the dp mean of the gradients over "dp", and the ``megatron_pipeline``
  example's step (both schedules): loss and synced gradients;
- ``gpipe_apply`` / ``interleaved_apply`` over a "pp" axis of one rank
  (the interleaved shift wraps onto the rank itself).

Tolerance 1e-6 of each reference's largest entry.  The rank-major forms
are held against the JAX package in tests/test_torch_tensor_parallel.py
and tests/test_torch_pipeline.py.  The processes write their checks to
JSON; the tests read them.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
RTOL = 1e-6

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import runtime
    from torchmpi_tpu_torch.examples import megatron_pipeline as mp
    from torchmpi_tpu_torch.parallel import pipeline as pp
    from torchmpi_tpu_torch.parallel import tensor as tp

    rank = RANK
    out = {}

    def err(got, want):
        got, want = got.detach().double(), want.detach().double()
        return [float((got - want).abs().max()), float(want.abs().max())]

    def init(shape):
        mpi.init(mpi.Config(mesh_shape=shape), device="cpu",
                 init_method=f"tcp://localhost:{PORT + len(out)}", rank=rank,
                 world_size=NRANKS)

    def block_params(g, D, F, n_tp, lead=()):
        # Full weights, their tp shards as stacks [n_tp, ...].
        s = 1.0 / D ** 0.5
        full = {"wq": torch.randn(D, D, generator=g) * s,
                "wk": torch.randn(D, D, generator=g) * s,
                "wv": torch.randn(D, D, generator=g) * s,
                "wo": torch.randn(D, D, generator=g) * s,
                "w1": torch.randn(D, F, generator=g) * s,
                "w2": torch.randn(F, D, generator=g) / F ** 0.5}
        return {k: torch.stack([
            (tp.shard_rows if k in ("wo", "w2") else tp.shard_columns)(
                w, None, n_tp, i) for i in range(n_tp)])
            for k, w in full.items()}

    # ---- pp 2 x tp 2: ranks (p, t) = (rank // 2, rank % 2) -----------------
    init({"pp": 2, "tp": 2})
    p, t = rank // 2, rank % 2
    c = {"coords": [runtime.axis_index("pp"), runtime.axis_index("tp"),
                    runtime.axis_index(("pp", "tp")),
                    mpi.collectives.axis_index(None)] == [p, t, rank, rank],
         "shape": mpi.world_shape() == {"pp": 2, "tp": 2},
         "sizes": [runtime.axis_size("pp"), runtime.axis_size("tp"),
                   runtime.axis_size(None)] == [2, 2, 4],
         "groups": [torch.distributed.get_world_size(runtime.group(a))
                    for a in ("pp", "tp")] == [2, 2]}
    g = torch.Generator().manual_seed(1)
    X = torch.randn(4, 6, generator=g)
    errs = []
    for axes in ("pp", "tp", ("pp", "tp"), ("tp", "pp"), None):
        errs.append(err(mpi.allreduce_in_axis(X[rank], axes),
                        mpi.allreduce_rank_major(X, axis_names=axes)[rank]))
        errs.append(err(mpi.allgather_in_axis(X[rank], axes),
                        mpi.allgather_rank_major(X, axis_names=axes)[rank]))
    out["verbs"] = {"flags": c, "errs": errs}

    # Pushed communicators: ranks [0, 1]; the world as an (a, b) grid.
    c = {}
    errs = []
    with mpi.communicator("pair", devices=[0, 1]) as pair:
        c["member"] = pair.member == (rank < 2)
        if rank < 2:
            errs.append(err(mpi.allreduce_in_axis(X[rank]), X[0] + X[1]))
            c["index"] = runtime.axis_index("ici") == rank
        else:
            try:
                runtime.axis_index("ici")
                c["refused"] = False
            except RuntimeError:
                c["refused"] = True
    with mpi.communicator("ab", shape={"a": 2, "b": 2}) as ab:
        errs.append(err(mpi.allreduce_in_axis(X[rank], "a"),
                        mpi.allreduce_rank_major(X, axis_names="a")[rank]))
        c["ab"] = runtime.axis_index("b") == t
    again = mpi.push_communicator("pair")
    c["cached"] = again is pair
    mpi.pop_communicator()
    # An identical re-push takes the cached communicator: no new group and
    # no plan miss.  A changed one replaces it and destroys its groups.
    made = []
    new_group = torch.distributed.new_group
    torch.distributed.new_group = lambda *a, **k: (made.append(a),
                                                   new_group(*a, **k))[1]
    try:
        mpi.planner.reset_stats()
        with mpi.communicator("ab", shape={"a": 2, "b": 2}) as ab2:
            mpi.allreduce_in_axis(X[rank], "a")
        c["repush"] = (ab2 is ab and not made
                       and mpi.planner.stats()["misses"] == 0)
        with mpi.communicator("ab", shape={"b": 2, "a": 2}) as ba:
            got = mpi.allreduce_in_axis(X[rank], "a")
            c["replaced plans anew"] = mpi.planner.stats()["misses"] == 1
            errs.append(err(got, mpi.allreduce_rank_major(
                X, axis_names="a")[rank]))
            c["ba"] = runtime.axis_index("a") == t
        c["replaced"] = ba is not ab and ab.groups == {}
        c["groups made"] = len(made) == 4
    finally:
        torch.distributed.new_group = new_group
    out["pushed"] = {"flags": c, "errs": errs}

    # The shifts over pp and their backward.
    errs = []
    Y = torch.randn(4, 3, generator=g)
    W = torch.randn(4, 3, generator=g)
    for wrap in (False, True):
        y = Y[rank].clone().requires_grad_()
        s = mpi.collectives.shift_in_axis_grad(y, "pp", wrap=wrap)
        (s * W[rank]).sum().backward()
        ys = Y.clone().requires_grad_()
        v = ys.view(2, 2, 3)
        first = v[-1:] if wrap else torch.zeros_like(v[:1])
        sh = torch.cat([first, v[:-1]]).reshape(4, 3)
        (sh * W).sum().backward()
        errs += [err(s, sh[rank]), err(y.grad, ys.grad[rank])]
    out["shift"] = {"flags": {}, "errs": errs}

    # TP blocks and the pipelines, T 8, D 8, 2 heads, F 16.
    B, T, D, F, H = 2, 8, 8, 16, 2
    ln = (torch.ones(D), torch.zeros(D))
    for impl in ("dense", "flash"):
        prm = block_params(torch.Generator().manual_seed(7), D, F, 2)
        x_all = torch.randn(2, B, T, D, generator=g)  # one per pp row
        wo = torch.randn(2, B, T, D, generator=g)
        rm = {k: v.repeat(2, *([1] * (v.dim() - 1))).clone()
              .requires_grad_() for k, v in prm.items()}
        xs = x_all.repeat_interleave(2, 0).clone().requires_grad_()
        o_rm = tp.tp_transformer_block_rank_major(
            xs, dict(rm, ln1=ln, ln2=ln), "tp", num_heads=H,
            attn_impl=impl)
        (o_rm * wo.repeat_interleave(2, 0)).sum().backward()
        mine = {k: v[t].clone().requires_grad_() for k, v in prm.items()}
        x = x_all[p].clone().requires_grad_()
        o = tp.tp_transformer_block(x, dict(mine, ln1=ln, ln2=ln), "tp",
                                    num_heads=H, attn_impl=impl)
        (o * wo[p]).sum().backward()
        out[f"tp-{impl}"] = {"flags": {}, "errs": [
            err(o, o_rm[rank]), err(x.grad, xs.grad[rank])] + [
            err(mine[k].grad, rm[k].grad[rank]) for k in prm]}

    for schedule in ("gpipe", "interleaved"):
        V = 1 if schedule == "gpipe" else 2
        M = 2 * 2
        gw = torch.Generator().manual_seed(9)
        chunks = [block_params(gw, D, F, 2) for _ in range(2 * V)]
        # Stage s's chunk v is logical chunk v * 2 + s; rank (s, t) holds
        # the tp shard t of each, [V, ...].
        stage = {k: torch.stack([torch.stack(
            [chunks[v * 2 + s][k] for v in range(V)]) for s in range(2)])
            for k in chunks[0]}                          # [S, V, n_tp, ...]
        mbs = torch.randn(M, B, T, D, generator=g)
        tgt = torch.randn(M, B, T, D, generator=g)

        def fn_rm(prm, x):
            return tp.tp_transformer_block_rank_major(
                x, dict(prm, ln1=ln, ln2=ln), "tp", num_heads=H)

        def fn_w(prm, x):
            return tp.tp_transformer_block(
                x, dict(prm, ln1=ln, ln2=ln), "tp", num_heads=H)

        rm = {k: v.movedim(2, 1).reshape(4, V, *v.shape[3:]).clone()
              .requires_grad_() for k, v in stage.items()}
        mine = {k: v[p, :, t].clone().requires_grad_()
                for k, v in stage.items()}
        if schedule == "gpipe":
            run_rm = lambda b: pp.gpipe_apply_rank_major(
                fn_rm, {k: v[:, 0] for k, v in rm.items()},
                mbs.expand(4, *mbs.shape), "pp", broadcast_out=b)
            run_w = lambda b: pp.gpipe_apply(
                fn_w, {k: v[0] for k, v in mine.items()}, mbs, "pp",
                broadcast_out=b)
        else:
            run_rm = lambda b: pp.interleaved_apply_rank_major(
                fn_rm, rm, mbs.expand(4, *mbs.shape), "pp", broadcast_out=b)
            run_w = lambda b: pp.interleaved_apply(fn_w, mine, mbs, "pp",
                                                   broadcast_out=b)
        errs = [err(run_w(True), run_rm(True)[rank])]
        last_rm = (torch.arange(4) // 2) == 1
        o_rm = run_rm(False)
        sq = ((o_rm - tgt) ** 2).reshape(4, -1).sum(1)
        torch.where(last_rm, sq, torch.zeros_like(sq)).sum().backward()
        o = run_w(False)
        last = torch.tensor(p == 1)
        torch.where(last, ((o - tgt) ** 2).sum(), o.new_zeros(())
                    ).backward()
        errs.append(err(o, o_rm[rank]))
        errs += [err(mine[k].grad, rm[k].grad[rank]) for k in mine]
        out[f"pipeline-{schedule}"] = {"flags": {}, "errs": errs}
    mpi.barrier()
    mpi.stop()

    # ---- dp 2 x tp 2: ranks (d, t) -----------------------------------------
    init({"dp": 2, "tp": 2})
    d, t = rank // 2, rank % 2
    flags = {"coords": [runtime.axis_index("dp"),
                        runtime.axis_index("tp")] == [d, t]}
    prm = block_params(torch.Generator().manual_seed(11), D, F, 2)
    x_all = torch.randn(2, B, T, D, generator=g)  # one per dp group
    rm = {k: v.repeat(2, *([1] * (v.dim() - 1))).clone().requires_grad_()
          for k, v in prm.items()}
    o_rm = tp.tp_transformer_block_rank_major(
        x_all.repeat_interleave(2, 0), dict(rm, ln1=ln, ln2=ln), "tp",
        num_heads=H)
    (o_rm ** 2).sum().backward()
    g_rm = [mpi.allreduce_rank_major(rm[k].grad, op="mean", axis_names="dp")
            for k in prm]
    mine = {k: v[t].clone().requires_grad_() for k, v in prm.items()}
    o = tp.tp_transformer_block(x_all[d], dict(mine, ln1=ln, ln2=ln), "tp",
                                num_heads=H)
    (o ** 2).sum().backward()
    g_w = mpi.allreduce_in_axis([mine[k].grad for k in prm], "dp",
                                op="mean")
    out["dp-mean"] = {"flags": flags, "errs": [err(o, o_rm[rank])] + [
        err(a, b[rank]) for a, b in zip(g_w, g_rm)]}
    mpi.barrier()
    mpi.stop()

    # ---- pp 2 x dp 2 x tp 1: the example's step ----------------------------
    init({"pp": 2, "dp": 2, "tp": 1})
    p, d = rank // 2, rank % 2
    S, n_dp, n_tp, Hm, Dm, Fm, Mm = 2, 2, 1, 1, 8, 16, 4
    rng = np.random.RandomState(3)
    xs = rng.randn(n_dp, Mm, 2, 8, Dm).astype(np.float32)
    ys = (rng.randn(n_dp, Mm, 2, 8, Dm) * 0.3).astype(np.float32)
    rows = [dd for _ in range(S) for dd in range(n_dp) for _ in range(n_tp)]
    for schedule in ("gpipe", "interleaved"):
        V = 2 if schedule == "interleaved" else 1
        blocks = [mp.dense_block(4 + l, Dm, Fm) for l in range(S * V)]
        staged = mp.staged_weights(blocks, S, n_tp)
        dev = torch.device("cpu")
        res = {}
        for rank_major in (True, False):
            if rank_major:
                params = mp.rank_major_params(staged, n_dp, dev)
                xt = torch.from_numpy(xs[rows])
                yt = torch.from_numpy(ys[rows])
            else:
                params = mp.local_params(staged, p, 0, dev)
                xt, yt = torch.from_numpy(xs[d]), torch.from_numpy(ys[d])
            step = mp.make_train_step(
                mp.make_stage_fn(Hm, Dm, dev, rank_major=rank_major), S,
                schedule=schedule, lr=0.05, rank_major=rank_major)
            loss, grads = step(params, xt, yt)
            res[rank_major] = (loss, grads, params)
        (l_rm, g_rm, p_rm), (l_w, g_w, p_w) = res[True], res[False]
        out[f"example-{schedule}"] = {"flags": {}, "errs": [
            err(l_w, l_rm[rank])] + [err(g_w[k], g_rm[k][rank])
                                    for k in mp.KEYS] + [
            err(p_w[k], p_rm[k][rank]) for k in mp.KEYS]}
    mpi.barrier()
    mpi.stop()

    # ---- pp 1 x dp 4: the pipelines over an axis of one rank --------------
    init({"pp": 1, "dp": 4})
    gq = torch.Generator().manual_seed(13)
    Wq = torch.randn(4, 2, 6, 6, generator=gq) / 6 ** 0.5  # [n, V, D, D]
    Xq = torch.randn(4, 4, 3, 6, generator=gq)             # [n, M, mb, D]
    errs = []
    for V in (1, 2):
        w_rm = Wq[:, :V].clone().requires_grad_()
        w = Wq[rank, :V].clone().requires_grad_()
        fn_rm = lambda prm, x: torch.tanh(torch.bmm(x, prm["w"]))
        fn_w = lambda prm, x: torch.tanh(x @ prm["w"])
        if V == 1:
            o_rm = pp.gpipe_apply_rank_major(fn_rm, {"w": w_rm[:, 0]}, Xq,
                                             "pp")
            o = pp.gpipe_apply(fn_w, {"w": w[0]}, Xq[rank], "pp")
        else:
            o_rm = pp.interleaved_apply_rank_major(fn_rm, {"w": w_rm}, Xq,
                                                   "pp")
            o = pp.interleaved_apply(fn_w, {"w": w}, Xq[rank], "pp")
        (o_rm * Xq).sum().backward()
        (o * Xq[rank]).sum().backward()
        errs += [err(o, o_rm[rank]), err(w.grad, w_rm.grad[rank])]
    out["pipeline-pp1"] = {"flags": {}, "errs": errs}
    mpi.barrier()
    mpi.stop()

    with open(OUT + f".{rank}", "w") as f:
        json.dump(out, f)
""")

CASES = ["verbs", "pushed", "shift", "tp-dense", "tp-flash",
         "pipeline-gpipe", "pipeline-interleaved", "dp-mean",
         "example-gpipe", "example-interleaved", "pipeline-pp1"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("nd_world") / "checks.json")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_WORLD_SIZE", "TORCHMPI_TPU_MESH_SHAPE"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER.replace("NRANKS", str(N))
         .replace("REPO", repr(REPO)).replace("RANK", str(r))
         .replace("PORT", str(port)).replace("OUT", repr(out))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(N)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    per_rank = []
    for r in range(N):
        with open(f"{out}.{r}") as f:
            per_rank.append(json.load(f))
    return per_rank


@pytest.mark.parametrize("case", CASES)
def test_process_world_equals_rank_major(results, case):
    for rank, res in enumerate(results):
        for name, ok in res[case]["flags"].items():
            assert ok, (rank, case, name)
        for j, (err, ref) in enumerate(res[case]["errs"]):
            assert err <= RTOL * max(ref, 1e-30), (rank, case, j, err, ref)
