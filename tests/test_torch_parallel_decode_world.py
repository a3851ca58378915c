"""The mesh-parallel decoders across processes: 4 gloo processes, one run
for the module, on the two-level world dcn 2 x ici 2.

Each process runs the process-world forms on its own shard and holds each
result against the rank-major form of all four ranks, which it computes
itself on the same seeded weights:

- ``tp_generate``, ``tp_beam_search`` and the slot primitives over a
  pushed communicator {"model": 4} (greedy, eos, sampled; the prefill's
  and a step's logits; a padded slot prefill and a verify step, their
  tokens and caches);
- ``pp_generate`` over {"pp": 4} (greedy, eos, sampled);
- ``generate_parallel`` / ``beam_search_parallel`` of an expert-parallel
  model (top-2, the experts over ici, the batch over dcn) and of a Ulysses
  model (the heads over ici);
- ``Server.sharded`` with 2 replicas of 2 processes: each process serves
  the replica that holds it, every stream equal to the rank-major
  ``tp_generate`` of its prompt alone, and its plan row says so.

Tokens identical; logits within 1e-6 of the rank-major form's largest
entry.  The rank-major forms are held against the JAX package in
tests/test_torch_tp_generate.py, test_torch_pp_generate.py,
test_torch_generate_parallel.py and test_torch_tp_serving.py.  The
processes write their checks to JSON; the tests read them.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
RTOL = 1e-6

WORKER = textwrap.dedent("""
    import importlib, json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import serving
    from torchmpi_tpu_torch.models import TransformerLM
    gen = importlib.import_module("torchmpi_tpu_torch.models.generate")
    tpg = importlib.import_module("torchmpi_tpu_torch.models.tp_generate")
    ppg = importlib.import_module("torchmpi_tpu_torch.models.pp_generate")

    rank = RANK
    out = {}
    mpi.init(mpi.Config(dcn_size=2), device="cpu",
             init_method=f"tcp://localhost:{PORT}", rank=rank,
             world_size=NRANKS)

    def eq(a, b):
        return bool(torch.equal(torch.as_tensor(a).long(),
                                torch.as_tensor(b).long()))

    def err(got, want):
        got, want = got.detach().double(), want.detach().double()
        return [float((got - want).abs().max()), float(want.abs().max())]

    g = torch.Generator().manual_seed(5)
    tree = tpg.init_tp_lm(g, vocab=64, embed=32, depth=4, num_heads=8,
                          device="cpu")
    prompt = np.random.RandomState(1).randint(0, 64, size=(4, 5)).astype(
        np.int32)

    # ---- tensor parallelism over {"model": 4} -----------------------------
    flags, errs = {}, []
    with mpi.communicator("m", shape={"model": 4}):
        kw = dict(axis="model", num_heads=8)
        for name, extra in (("greedy", {}), ("eos", {"eos_id": 7}),
                            ("sampled", {"temperature": 0.9, "top_k": 9,
                                         "seed": 3})):
            flags[name] = eq(tpg.tp_generate(tree, prompt, 6, **kw, **extra),
                             tpg.tp_generate_rank_major(tree, prompt, 6, n=4,
                                                        **kw, **extra))
        for beams in (1, 3):
            flags[f"beam{beams}"] = eq(
                tpg.tp_beam_search(tree, prompt, 5, beams=beams,
                                   length_penalty=0.6, **kw),
                tpg.tp_beam_search_rank_major(tree, prompt, 5, beams=beams,
                                              length_penalty=0.6, n=4, **kw))
        pw = tpg._Stack(tpg.shard_tp_lm(tree, "model")[0],
                        tpg._Form("model", None, None), 8)
        rm = tpg._Stack(tpg.shard_tp_lm_rank_major(tree, 4, "model")[0],
                        tpg._Form("model", 4, None), 8)
        p = torch.from_numpy(prompt)
        (xa, ca), (xb, cb) = pw.prefill(p, 8), rm.prefill(p, 8)
        errs.append(err(pw.logits(xa[:, :, -1]), rm.logits(xb[:, :, -1])))
        errs.append(err(ca.k[1][0], cb.k[1][rank]))
        tok = torch.tensor([1, 2, 3, 4])
        pos = torch.full((4,), 5)
        errs.append(err(pw.logits(pw.decode(ca, tok[:, None], pos)[:, :, 0]),
                        rm.logits(rm.decode(cb, tok[:, None], pos)[:, :, 0])))
        # The slot primitives: a padded prefill, then a verify step.
        mine = tpg.shard_tp_lm(tree, "model")[0]
        pc, pf = tpg.tp_slot_prefill(mine, prompt[:1], t_max=12, true_len=4,
                                     **kw)
        rs = tpg.shard_tp_lm_rank_major(tree, 4, "model")[0]
        rc, rf = tpg.tp_slot_prefill_rank_major(rs, prompt[:1], t_max=12,
                                                true_len=4, **kw)
        flags["slot_prefill"] = eq(pf, rf)
        errs.append(err(pc.k[0][0], rc.k[0][rank]))
        ver = np.array([[int(pf[0]), 3, 5]])
        at = torch.tensor([4])
        pc, po = tpg.tp_slot_decode(mine, pc, ver, at, **kw)
        rc, ro = tpg.tp_slot_decode_rank_major(rs, rc, ver, at, **kw)
        flags["slot_decode"] = eq(po, ro)
        errs.append(err(pc.v[1][0], rc.v[1][rank]))
    out["tp"] = {"flags": flags, "errs": errs}

    # ---- pipeline parallelism over {"pp": 4} ------------------------------
    flags = {}
    p8 = np.random.RandomState(2).randint(0, 64, size=(8, 4)).astype(
        np.int32)
    with mpi.communicator("s", shape={"pp": 4}):
        kw = dict(axis="pp", num_heads=8)
        for name, extra in (("greedy", {}), ("eos", {"eos_id": 11}),
                            ("sampled", {"temperature": 1.0, "seed": 4})):
            flags[name] = eq(ppg.pp_generate(tree, p8, 5, **kw, **extra),
                             ppg.pp_generate_rank_major(tree, p8, 5, n=4,
                                                        **kw, **extra))
    out["pp"] = {"flags": flags, "errs": []}

    # ---- generate_parallel on dcn 2 x ici 2 -------------------------------
    def model(**kw):
        return TransformerLM(vocab=29, embed=32, depth=2, num_heads=4,
                             head_dim=8, max_len=24, device="cpu",
                             generator=torch.Generator().manual_seed(7),
                             **kw)

    for case, m in (("ep", model(moe_axis="ici", moe_experts_per_device=1,
                                 moe_k=2, moe_capacity_factor=8.0,
                                 moe_axis_size=2)),
                    ("ulysses", model(attn_impl="ulysses", seq_axis="ici"))):
        flags = {}
        pr = np.random.RandomState(3).randint(0, 29, size=(4, 5)).astype(
            np.int32)
        for name, extra in (("greedy", {}),
                            ("sampled", {"temperature": 1.0, "seed": 9})):
            flags[name] = eq(
                gen.generate_parallel(m, pr, 6, batch_axis="dcn", **extra),
                gen.generate_parallel_rank_major(m, pr, 6, n=4,
                                                 batch_axis="dcn", **extra))
        flags["beam"] = eq(
            gen.beam_search_parallel(m, pr, 5, beams=3, batch_axis="dcn",
                                     eos_id=2),
            gen.beam_search_parallel_rank_major(m, pr, 5, n=4, beams=3,
                                                batch_axis="dcn", eos_id=2))
        flags["no_batch_axis"] = eq(
            gen.generate_parallel(m, pr, 4),
            gen.generate_parallel_rank_major(m, pr, 4, n=4))
        out[case] = {"flags": flags, "errs": []}

    # ---- Server.sharded: 2 replicas of 2 processes ------------------------
    flags = {}
    tree2 = tpg.init_tp_lm(torch.Generator().manual_seed(6), vocab=64,
                           embed=32, depth=2, num_heads=4, device="cpu")
    rng = np.random.RandomState(13)
    prompts = rng.randint(0, 64, size=(6, 5)).astype(np.int32)
    lens = [4, 8, 4, 8, 4, 8]
    srv = serving.Server.sharded(tree2, tp=2, num_heads=4, slot_tokens=32,
                                 replicas=2, slots=2)
    reqs = [serving.Request(f"t{i}", prompts[i], max_new=lens[i],
                            arrival_s=0.001 * i,
                            temperature=0.8 if i % 3 == 2 else None,
                            seed=i) for i in range(6)]
    done = srv.run_trace(reqs, tick_seconds=0.001)
    mine = srv.router.replicas[0]
    flags["one_replica_holds_me"] = (len(srv.router.replicas) == 1
                                     and mine.name == f"tp{rank // 2}")
    flags["all_served"] = len(done) == 6
    with mpi.communicator("pair", devices=[0, 1], shape={"model": 2}):
        for i, r in enumerate(reqs):
            want = tpg.tp_generate_rank_major(
                tree2, prompts[i:i + 1], lens[i], axis="model", n=2,
                num_heads=4, temperature=r.temperature or 0.0,
                seed=r.seed)[0, 5:].tolist()
            flags[f"stream{i}"] = r.tokens == want
    rows = [d for d in mpi.planner.describe() if d["kind"] == "serving"]
    flags["plan_row"] = any(d["backend"] == "process_world"
                            and d["topology"] == "model=2" for d in rows)
    out["server"] = {"flags": flags, "errs": []}
    mpi.barrier()
    mpi.stop()
    with open(OUT + f".{rank}", "w") as f:
        json.dump(out, f)
""")

CASES = ["tp", "pp", "ep", "ulysses", "server"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("decode_world") / "checks.json")
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
