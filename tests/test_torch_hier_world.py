"""The two-level world across processes: 4 gloo processes as dcn 2 x ici 2
(``Config(dcn_size=2)``), one group for the whole module.

Each process builds the subgroups at ``init`` (``runtime.group``), runs the
process-world forms (the six hierarchical verbs, the in-axis verbs over one
axis, the dcn codecs, the error-feedback gradient sync, its overlapped form
and the ZeRO-1 leg) on its own rank's tensors, and holds each result against
its slice of the rank-major form of the four ranks' tensors, which it
computes itself from the same seeded data: bitwise, since every sum here
adds two values at a time (two-member groups).  The rank-major forms are
held against the JAX package in tests/test_torch_hierarchical.py and
tests/test_torch_compress.py.  The processes write their checks to JSON;
the tests read them.
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

VERB_CASES = [
    ("allreduce_f32_chunked", "allreduce", {"op": "sum"}, "f32"),
    ("allreduce_i32", "allreduce", {"op": "sum"}, "i32"),
    ("allreduce_max", "allreduce", {"op": "max"}, "f32"),
    ("allreduce_mean", "allreduce", {"op": "mean"}, "f32"),
    ("broadcast3", "broadcast", {"root": 3}, "f32"),
    ("reduce2_sum", "reduce", {"root": 2, "op": "sum"}, "i32"),
    ("reduce1_mean", "reduce", {"root": 1, "op": "mean"}, "f32"),
    ("allgather", "allgather", {}, "f32"),
    ("gather1", "gather", {"root": 1}, "i32"),
    ("scatter3", "scatter", {"root": 3}, "f32"),
]
AXIS_CASES = [
    (verb, axis, params)
    for axis in ("ici", "dcn")
    for verb, params in (("allreduce", {}), ("allgather", {}),
                         ("reduce_scatter", {}), ("broadcast", {"root": 1}),
                         ("gather", {"root": 1}), ("scatter", {"root": 0}),
                         ("alltoall", {}))
]
CODEC_CASES = ["bf16", "int8", "fp8"]

WORKER = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import fusion, optim, runtime
    from torchmpi_tpu_torch.parallel import gradsync, zero

    out = {}
    mpi.init(device="cpu", init_method=f"tcp://localhost:{PORT}",
             rank=RANK, world_size=4, dcn_size=2, custom_min_bytes=0,
             dcn_compress_min_bytes=0)
    rng = np.random.RandomState(0)
    F32 = torch.from_numpy(rng.randn(4, 32, 12).astype(np.float32))
    I32 = torch.from_numpy(rng.randint(-99, 99, (4, 32, 12)).astype(
        np.int32))
    DATA = {"f32": F32, "i32": I32}

    def same(a, b):
        return bool(a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a, b))

    gi, gd = runtime.group("ici"), runtime.group("dcn")
    out["grid"] = [list(runtime.grid()), runtime.axis_index("dcn"),
                   runtime.axis_index("ici"),
                   dist.get_process_group_ranks(gi),
                   dist.get_process_group_ranks(gd)]

    mpi.set_config(dcn_chunk_bytes=128)
    for name, verb, params, dt in VERB_CASES:
        xs = DATA[dt]
        got = getattr(mpi, verb)(xs[RANK], backend="hierarchical", **params)
        want = getattr(mpi, verb + "_rank_major")(
            xs, backend="hierarchical", **params)[RANK]
        out["verb " + name] = same(got, want)
    mpi.set_config(dcn_chunk_bytes=4 << 20)

    for verb, axis, params in AXIS_CASES:
        xs = DATA["i32"]
        got = getattr(mpi, verb + "_in_axis")(xs[RANK], axis, **params)
        want = getattr(mpi, verb + "_rank_major")(
            xs, axis_names=axis, **params)[RANK]
        h = getattr(mpi.async_in_axis, verb)(xs[RANK], axis, **params)
        out[f"axis {verb} {axis}"] = same(got, want) and same(h.wait(), want)

    for codec in CODEC_CASES:
        mpi.set_config(dcn_compress=codec)
        got = mpi.allreduce(F32[RANK], backend="hierarchical")
        want = mpi.allreduce_rank_major(F32, backend="hierarchical")[RANK]
        out["codec " + codec] = same(got, want)
    mpi.set_config(dcn_compress="off")

    # The error-feedback sync, three steps, residuals threaded.
    shapes = [(40,), (16, 9)]
    tmpl = [torch.zeros(s) for s in shapes]
    res_p = gradsync.init_dcn_residuals(tmpl)
    res_r = gradsync.init_dcn_residuals(tmpl, n=4)
    ok = [x.shape[-1] for x in res_p] == [x.shape[-1] for x in res_r]
    for step in range(3):
        g = [torch.from_numpy(rng.randn(4, *s).astype(np.float32))
             for s in shapes]
        mine = [t[RANK].clone() for t in g]
        res_p = gradsync.synchronize_gradient_tensors(
            mine, residuals=res_p, dcn_compress="int8")
        stacks, res_r = gradsync.synchronize_gradients_rank_major(
            [t.clone() for t in g], residuals=res_r, dcn_compress="int8")
        ok = ok and all(same(a, b[RANK]) for a, b in zip(mine, stacks))
        ok = ok and all(same(a, b[RANK]) for a, b in zip(res_p, res_r))
    out["ef sync"] = ok

    # ZeRO-1 with the error-feedback leg, two steps.
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in shapes]
    tx = optim.sgd(0.1)
    zres_p = zero.init_dcn_residuals(params)
    zres_r = zero.init_dcn_residuals(params, n=4)
    st_p = zero.init(params, tx)
    st_r = zero.init_rank_major(params, tx, 4)
    spec = zero.flat_spec(params, n_shards=4)
    p_p, p_r, ok = params, params, True
    for step in range(2):
        g = [torch.from_numpy(rng.randn(4, *s).astype(np.float32))
             for s in shapes]
        p_p, st_p, zres_p = zero.update(
            p_p, [t[RANK] for t in g], st_p, tx, dcn_residuals=zres_p,
            dcn_compress="int8")
        p_r, st_r, zres_r = zero.update_rank_major(
            p_r, fusion.group_flats(g, spec), st_r, tx,
            dcn_residuals=zres_r, dcn_compress="int8")
        ok = ok and all(same(a, b) for a, b in zip(p_p, p_r))
        ok = ok and all(same(a, b[RANK]) for a, b in zip(zres_p, zres_r))
    out["ef zero1"] = ok

    # The overlapped form with error feedback, two steps.
    w = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    b = torch.from_numpy(rng.randn(8).astype(np.float32))

    def loss_fn(leaves, x):
        tb, tw = leaves
        return ((x @ tw + tb) ** 2).mean()

    vp = gradsync.make_overlapped_grad_fn(loss_fn, [b, w], residuals=True,
                                          dcn_compress="int8", max_bytes=256)
    vr = gradsync.make_overlapped_grad_fn_rank_major(
        loss_fn, [b, w], 4, residuals=True, dcn_compress="int8",
        max_bytes=256)
    ores_p = gradsync.init_overlap_dcn_residuals([b, w], max_bytes=256)
    ores_r = gradsync.init_overlap_dcn_residuals([b, w], max_bytes=256, n=4)
    ok = True
    for step in range(2):
        x = torch.from_numpy(rng.randn(4 * 3, 16).astype(np.float32))
        _, (gp, ores_p) = vp([b, w], ores_p, x[3 * RANK:3 * RANK + 3])
        _, (gr, ores_r) = vr([b, w], ores_r, x)
        ok = ok and all(same(a, s[RANK]) for a, s in zip(gp, gr))
        ok = ok and all(same(a, s[RANK]) for a, s in zip(ores_p, ores_r))
    out["ef overlap"] = ok

    with open(f"{OUTDIR}/rank{RANK}.json", "w") as f:
        json.dump(out, f)
    mpi.barrier()
    mpi.stop()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The four processes' checks, rank by rank."""
    outdir = tmp_path_factory.mktemp("hier_world")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    head = (f"REPO = {REPO!r}\nPORT = {port}\nOUTDIR = {str(outdir)!r}\n"
            f"VERB_CASES = {VERB_CASES!r}\nAXIS_CASES = {AXIS_CASES!r}\n"
            f"CODEC_CASES = {CODEC_CASES!r}\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", head + f"RANK = {r}\n" + WORKER], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(N)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [json.loads((outdir / f"rank{r}.json").read_text())
            for r in range(N)]


def test_subgroups_and_grid(results):
    """Rank d * 2 + i: its node's ici group and its index's dcn group."""
    for r, res in enumerate(results):
        grid, d, i, ici, dcn = res["grid"]
        assert grid == [2, 2] and (d, i) == divmod(r, 2)
        assert ici == [2 * d, 2 * d + 1] and dcn == [i, 2 + i]


@pytest.mark.parametrize("name", [c[0] for c in VERB_CASES])
def test_hier_verbs_bitwise_to_rank_major(results, name):
    assert all(res["verb " + name] for res in results)


@pytest.mark.parametrize("verb,axis", [(c[0], c[1]) for c in AXIS_CASES])
def test_in_axis_sub_axes_bitwise_to_rank_major(results, verb, axis):
    assert all(res[f"axis {verb} {axis}"] for res in results)


@pytest.mark.parametrize("codec", CODEC_CASES)
def test_dcn_codec_allreduce_bitwise_to_rank_major(results, codec):
    assert all(res["codec " + codec] for res in results)


@pytest.mark.parametrize("what", ["ef sync", "ef zero1", "ef overlap"])
def test_error_feedback_bitwise_to_rank_major(results, what):
    assert all(res[what] for res in results)


@pytest.mark.parametrize("world,local,cfg,want", [
    (8, "4", {}, (2, 4)), (8, "8", {}, (1, 8)), (8, "3", {}, (1, 8)),
    (8, None, {}, (1, 8)), (1, "1", {"dcn_size": 2}, (1, 1)),
    (4, "4", {"dcn_size": 2}, (2, 2)), (4, None, {"ici_size": 1}, (4, 1)),
    (4, None, {"dcn_size": 3}, "dcn_size=3 does not divide device count 4"),
])
def test_process_world_grid_rule(monkeypatch, world, local, cfg, want):
    """The process world's grid: the topology fields, else the node count
    ``WORLD_SIZE / LOCAL_WORLD_SIZE`` where it divides, else one node; a
    world of one process is (1, 1)."""
    from torchmpi_tpu_torch import Config, runtime

    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            runtime._world_grid(Config(**cfg), world)
    else:
        assert runtime._world_grid(Config(**cfg), world) == want
