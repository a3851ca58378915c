"""Sequence-parallel attention across processes: 2 gloo processes, one
group for the whole module.

Each process runs the process-world forms over "ici" on its own shard
(``ring_attention`` and ``ulysses_attention``, dense and flash blocks; the
model's sequence-parallel impls with ``pos_offset``; one
``longcontext_lm`` step with its world sums and the summed gradient sync),
and holds each result against its slice of the rank-major form of both
ranks' shards, which it computes itself from the same seeded data: the
output and the gradients with respect to its q / k / v shard (through the
rotation's and the all-to-all's backward across the processes), the
model's gradients summed over the world, the example's loss and synced
gradients.  Tolerance 1e-6 of each reference's largest entry.  The
rank-major forms are held against the JAX package in
tests/test_torch_sequence.py.  The processes write their checks to JSON;
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
N = 2
RTOL = 1e-6

ATTN_CASES = [f"{kind}-{block}-{mode}" for kind in ("ring", "ulysses")
              for block in ("dense", "flash")
              for mode in ("full", "causal", "window")]
MODEL_CASES = ["ring", "ring_flash", "ulysses", "ulysses_flash"]
EXAMPLE_CASES = ["ring", "ring_flash", "ulysses"]

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import optim
    from torchmpi_tpu_torch.examples import longcontext_lm as lc
    from torchmpi_tpu_torch.models import TransformerLM
    from torchmpi_tpu_torch.parallel import gradsync
    from torchmpi_tpu_torch.parallel import sequence as seq

    rank, N = RANK, NRANKS
    mpi.init(device="cpu", init_method="tcp://localhost:PORT", rank=rank,
             world_size=N)
    out = {}

    def err(got, want):
        got, want = got.detach().double(), want.detach().double()
        return [float((got - want).abs().max()), float(want.abs().max())]

    def mine(stack):
        return stack[rank]

    # Attention: B 1, T 16 (8 a rank), H 2, D 8.
    for kind in ("ring", "ulysses"):
        for block in ("dense", "flash"):
            for mode in ("full", "causal", "window"):
                g = torch.Generator().manual_seed(7)
                q, k, v, w = (torch.randn(N, 1, 8, 2, 8, generator=g)
                              for _ in range(4))
                kw = dict(causal=mode != "full", block_impl=block,
                          window=5 if mode == "window" else None)
                fn_rm = (seq.ring_attention_rank_major if kind == "ring"
                         else seq.ulysses_attention_rank_major)
                fn = (seq.ring_attention if kind == "ring"
                      else seq.ulysses_attention)
                xs = [t.clone().requires_grad_() for t in (q, k, v)]
                o_rm = fn_rm(*xs, **kw)
                (o_rm * w).sum().backward()
                ys = [mine(t).clone().requires_grad_() for t in (q, k, v)]
                o = fn(*ys, "ici", **kw)
                (o * mine(w)).sum().backward()
                name = f"{kind}-{block}-{mode}"
                out[name] = [err(o, mine(o_rm))] + [
                    err(y.grad, mine(x.grad)) for x, y in zip(xs, ys)]

    # The model: vocab 32, embed 32, depth 2, 4 heads of 8, RoPE, T 16;
    # the world's gradients summed over the ranks.
    for impl in ("ring", "ring_flash", "ulysses", "ulysses_flash"):
        def build():
            return TransformerLM(vocab=32, embed=32, depth=2, num_heads=4,
                                 head_dim=8, max_len=16, attn_impl=impl,
                                 seq_axis="ici", pos_emb="rope",
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(3))
        g = torch.Generator().manual_seed(5)
        tok = torch.randint(0, 32, (N, 2, 8), generator=g)
        wl = torch.randn(N, 2, 8, 32, generator=g)
        ref = build()
        logits_rm = ref.forward_rank_major(tok)
        (logits_rm * wl).sum().backward()
        model = build()
        logits = model(mine(tok), pos_offset=mpi.runtime.axis_index("ici")
                       * 8)
        (logits * mine(wl)).sum().backward()
        grads = [p.grad for p in model.parameters()]
        gradsync.synchronize_gradient_tensors(grads, op="sum")
        out[f"model-{impl}"] = [err(logits, mine(logits_rm))] + [
            err(a, b.grad) for a, b in zip(grads, ref.parameters())]

    # One longcontext_lm step, T 32, batch 4, the example's model.
    for attn in ("ring", "ring_flash", "ulysses"):
        args = lc.common.parse_args("", ["--seed", "1", "--attn", attn],
                                    seq_len=dict(type=int, default=32),
                                    vocab=dict(type=int, default=64),
                                    attn=dict(type=str, default="ring"))
        batch = lc.make_batch(np.random.RandomState(2), 4, 32, 64)
        res = {}
        for rank_major in (True, False):
            model = lc.make_model(args, torch.device("cpu"), 32)
            tx = optim.adam(3e-3)
            step = lc.make_train_step(model, tx, rank_major=rank_major,
                                      grid_size=N)
            _, loss, grads = step(
                [tx.init(p.detach()) for p in model.parameters()],
                *lc.shard_batch(*batch, 1, N, torch.device("cpu"),
                                rank_major=rank_major))
            res[rank_major] = (loss, grads)
        (l_rm, g_rm), (l_w, g_w) = res[True], res[False]
        out[f"example-{attn}"] = [err(l_w, l_rm)] + [
            err(a, b) for a, b in zip(g_w, g_rm)]

    with open(OUT + f".{rank}", "w") as f:
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
    out = str(tmp_path_factory.mktemp("seq_world") / "checks.json")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
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


def _check(results, name):
    for rank, res in enumerate(results):
        for i, (err, ref) in enumerate(res[name]):
            assert err <= RTOL * max(ref, 1e-30), (rank, name, i, err, ref)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_process_world_attention_equals_rank_major(results, case):
    _check(results, case)


@pytest.mark.parametrize("impl", MODEL_CASES)
def test_process_world_model_equals_rank_major(results, impl):
    _check(results, f"model-{impl}")


@pytest.mark.parametrize("attn", EXAMPLE_CASES)
def test_process_world_example_step_equals_rank_major(results, attn):
    """The world's psum / psum loss and summed sync against the rank-major
    loss with its gradients scaled by the grid's size: the same loss, the
    same synced gradients (ROADMAP queue C note 22)."""
    _check(results, f"example-{attn}")
