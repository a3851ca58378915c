"""The expert-parallel MoE layer across processes: 4 gloo processes as a
dcn 2 x ici 2 world (``Config(dcn_size=2)``), one group for the whole
module.

Each process runs the process-world forms on its own rank's data, and
holds each result against its slice of the rank-major form of all four
ranks' data, which it computes itself from the same seeded tensors:

- ``moe_layer`` with the expert group over "ici", "dcn" and both axes, at
  k 1 and 2: the routing of its tokens (``topk_dispatch`` on its rank
  alone against its slice of the rank-major stack, bit for bit), the
  output, and the gradients of ``sum(out * w)`` with respect to its
  tokens (through both all-to-alls' backward across the processes), the
  gate and the expert weights (each summed over the world);
- a small MoE LM (``moe_axis="ici"``, top-2): the logits, each layer's
  aux loss and the gradients summed over the world;
- one ``moe_lm`` step at k 1 and 2: the loss and the synced gradients.

Tolerance 1e-6 of each reference's largest entry.  The rank-major forms
are held against the JAX package in tests/test_torch_expert.py.  The
processes write their checks to JSON; the tests read them.
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

LAYER_CASES = [f"{axis}-k{k}" for axis in ("ici", "dcn", "world")
               for k in (1, 2)]
EXAMPLE_CASES = [1, 2]

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import optim
    from torchmpi_tpu_torch.examples import moe_lm
    from torchmpi_tpu_torch.models import TransformerLM
    from torchmpi_tpu_torch.parallel import expert as ep
    from torchmpi_tpu_torch.parallel import gradsync

    rank = RANK
    mpi.init(device="cpu", init_method="tcp://localhost:PORT", rank=rank,
             world_size=NRANKS, dcn_size=2)
    d, i = mpi.runtime.axis_index("dcn"), mpi.runtime.axis_index("ici")
    out = {}

    def err(got, want):
        got, want = got.detach().double(), want.detach().double()
        return [float((got - want).abs().max()), float(want.abs().max())]

    def world_sum(t):
        return mpi.allreduce(t.detach().contiguous())

    def experts(w, tokens):
        return torch.tanh(tokens @ w)

    # The layer: T 16, D 8, 2 experts a rank of the group.
    T, D, E_LOCAL = 16, 8, 2
    for name, axis, G, gi in (("ici", "ici", 2, i), ("dcn", "dcn", 2, d),
                              ("world", ("dcn", "ici"), 4, rank)):
        for k in (1, 2):
            g = torch.Generator().manual_seed(11)
            E = G * E_LOCAL
            X = torch.randn(2, 2, T, D, generator=g)
            gate = torch.randn(D, E, generator=g)
            W = torch.randn(E, D, D, generator=g) * 0.3
            wo = torch.randn(2, 2, T, D, generator=g)
            xs, gs, ws = (t.clone().requires_grad_() for t in (X, gate, W))
            o_rm = ep.moe_layer_rank_major(xs, gs, experts, ws, axis, k=k,
                                           capacity_factor=0.5 * k)
            (o_rm * wo).sum().backward()
            x, gt, wf = (t.clone().requires_grad_()
                         for t in (X[d, i], gate, W))
            o = ep.moe_layer(x, gt, experts,
                             wf[gi * E_LOCAL:(gi + 1) * E_LOCAL], axis, k=k,
                             capacity_factor=0.5 * k)
            (o * wo[d, i]).sum().backward()
            C = max(1, int(0.5 * k * T * k / E))
            probs = torch.softmax(X @ gate, dim=-1)
            mine = ep.topk_dispatch(X[d, i], None, E, C, k, probs=probs[d, i])
            stack = ep.topk_dispatch(X, None, E, C, k, probs=probs)
            routing = all(torch.equal(a, b[d, i]) for a, b in zip(mine, stack))
            out[f"{name}-k{k}"] = {
                "routing": routing,
                "errs": [err(o, o_rm[d, i]), err(x.grad, xs.grad[d, i]),
                         err(world_sum(gt.grad), gs.grad),
                         err(world_sum(wf.grad), ws.grad)]}

    # The model: vocab 32, embed 16, depth 2, 2 heads of 8, T 8, b 2.
    def build():
        return TransformerLM(vocab=32, embed=16, depth=2, num_heads=2,
                             head_dim=8, max_len=8, moe_axis="ici",
                             moe_axis_size=2, moe_k=2, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(5)
    tok = torch.randint(0, 32, (2, 2, 2, 8), generator=g)
    wl = torch.randn(2, 2, 2, 8, 32, generator=g)
    ref = build()
    logits_rm = ref.forward_rank_major(tok)
    (logits_rm * wl).sum().backward()
    model = build()
    logits = model(tok[d, i])
    (logits * wl[d, i]).sum().backward()
    grads = [p.grad for p in model.parameters()]
    gradsync.synchronize_gradient_tensors(grads, op="sum")
    out["model"] = {"routing": True, "errs": [err(logits, logits_rm[d, i])] + [
        err(a, b[rank]) for a, b in zip(model.moe_aux_losses(),
                                        ref.moe_aux_losses())] + [
        err(a, b.grad) for a, b in zip(grads, ref.parameters())]}

    # One moe_lm step, batch 8 over dcn, T 16.
    for top_k in (1, 2):
        args = moe_lm.common.parse_args("", ["--top-k", str(top_k)],
                                        vocab=dict(type=int, default=64),
                                        top_k=dict(type=int, default=1))
        batch = moe_lm.make_batch(np.random.RandomState(2), 8, 16, 64)
        res = {}
        for rank_major in (True, False):
            model = moe_lm.make_model(args, torch.device("cpu"), 16, 2)
            tx = optim.adam(3e-3)
            step = moe_lm.make_train_step(model, tx, rank_major=rank_major,
                                          grid_size=NRANKS)
            _, loss, grads = step(
                [tx.init(p.detach()) for p in model.parameters()],
                moe_lm.shard_batch(batch, 2, 2, torch.device("cpu"),
                                   rank_major=rank_major))
            res[rank_major] = (loss, grads)
        (l_rm, g_rm), (l_w, g_w) = res[True], res[False]
        out[f"example-k{top_k}"] = {"routing": True, "errs": [
            err(l_w, l_rm)] + [err(a, b) for a, b in zip(g_w, g_rm)]}

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
    out = str(tmp_path_factory.mktemp("expert_world") / "checks.json")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_WORLD_SIZE"):
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
        assert res[name]["routing"], (rank, name, "routing differs")
        for j, (err, ref) in enumerate(res[name]["errs"]):
            assert err <= RTOL * max(ref, 1e-30), (rank, name, j, err, ref)


@pytest.mark.parametrize("case", LAYER_CASES)
def test_process_world_layer_equals_rank_major(results, case):
    _check(results, case)


def test_process_world_model_equals_rank_major(results):
    _check(results, "model")


@pytest.mark.parametrize("top_k", EXAMPLE_CASES)
def test_process_world_example_step_equals_rank_major(results, top_k):
    """Each rank's own loss backpropagated and the sum over the world,
    against the rank-major mean loss's gradients scaled by the grid's
    size: the same loss, the same synced gradients (ROADMAP queue C note
    23)."""
    _check(results, f"example-k{top_k}")
