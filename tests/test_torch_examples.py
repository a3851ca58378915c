"""The port's examples (torchmpi_tpu_torch/examples/) on the CPU: each
``main`` runs a few steps as a world of one (gloo), or rank-major with
``--devices 2`` (``mnist_fsdp`` with 4), and its loss falls; ``mnist_async_allreduce``'s
overlapped run equals its bucketed one, and ``--eager-loss`` reduces the
loss through the staged path; the flags of once-unported ROADMAP items
run (``--restart-loop`` recovering from a stall and from a crash with the
clean run's LOSS-DIGEST); the parameter-server examples
(``mnist_downpour``, ``mnist_easgd``, ``alexnet_downpour``) and
``checkpoint_resume`` run a few steps; ``longcontext_lm`` runs 3 steps
rank-major (the flash ring on 4 ranks) and in the world of one (dense
Ulysses), and, ``slow``, its full run to the JAX bar on dcn 2 x ici 4;
``moe_lm`` runs 3 steps rank-major (8 experts, top-2) and in the world of
one, and, ``slow``, its full run to the JAX bar; ``megatron_pipeline`` runs
3 steps rank-major (pp 2 x tp 4, and pp 2 x dp 2 x tp 2 interleaved), its
step's synced gradient equals the gradient of the dp-mean loss through
the unsharded blocks (no factor), and, ``slow``, its full run to the JAX
bar.  The full-length runs to the JAX
examples' accuracy bars (MNIST > 0.9, CIFAR > 0.85) are ``slow`` here, as
JAX's ``test_resnet20_dp_convergence`` is, and run on the card in
chip_smoke.py's ``cnn_examples`` phase."""

import importlib
import json

import numpy as np
import pytest
import torch

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import selector as tsel

torch.set_num_threads(2)

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def no_runtime():
    """Each example starts and stops its own runtime."""
    tmpi.stop()
    yield
    tmpi.stop()


def _main(name, argv):
    mod = importlib.import_module(f"torchmpi_tpu_torch.examples.{name}")
    return mod.main(CPU + argv)


@pytest.mark.parametrize("name,argv", [
    ("mnist_sequential", ["--steps", "21", "--batch-size", "64"]),
    ("mnist_allreduce", ["--steps", "21", "--batch-size", "64"]),
    ("mnist_allreduce", ["--steps", "21", "--batch-size", "64",
                         "--devices", "2", "--backend", "pallas"]),
    ("cifar_resnet20", ["--steps", "11", "--batch-size", "32"]),
    ("cifar_resnet20", ["--steps", "11", "--batch-size", "32", "--zero",
                        "3"]),
    ("cifar_resnet20", ["--steps", "11", "--batch-size", "32", "--zero",
                        "1", "--devices", "2", "--backend", "pallas"]),
    ("imagenet_resnet50", ["--steps", "3", "--warmup", "0", "--batch-size",
                           "4", "--image-size", "32", "--num-classes", "10"]),
    ("cifar_resnet20", ["--steps", "11", "--batch-size", "32", "--buckets",
                        "4", "--devices", "2"]),
    ("mnist_async_allreduce", ["--steps", "21", "--batch-size", "64"]),
    ("mnist_async_allreduce", ["--steps", "21", "--batch-size", "64",
                               "--devices", "2", "--backend", "pallas"]),
    ("mnist_fsdp", ["--steps", "10", "--devices", "4"]),
    ("mnist_allreduce", ["--steps", "10", "--batch-size", "64",
                         "--devices", "8", "--dcn", "2", "--backend",
                         "hierarchical"]),
    ("mnist_allreduce", ["--steps", "10", "--batch-size", "64",
                         "--devices", "8", "--dcn", "2", "--backend",
                         "pallas"]),
    ("cifar_resnet20", ["--steps", "10", "--batch-size", "32",
                        "--devices", "4", "--dcn", "2"]),
    ("mnist_allreduce", ["--steps", "10", "--batch-size", "64",
                         "--dcn", "2", "--backend", "pallas"]),
    ("longcontext_lm", ["--steps", "3", "--devices", "4", "--attn",
                        "ring_flash"]),
    ("longcontext_lm", ["--steps", "3", "--attn", "ulysses"]),
    ("moe_lm", ["--steps", "3", "--devices", "8", "--top-k", "2"]),
    ("moe_lm", ["--steps", "3"]),
    ("megatron_pipeline", ["--steps", "3", "--devices", "8"]),
    ("megatron_pipeline", ["--steps", "3", "--devices", "8", "--dp", "2",
                           "--schedule", "interleaved"]),
], ids=["sequential", "allreduce", "allreduce-rank-major", "cifar",
        "cifar-zero3", "cifar-zero1-rank-major", "resnet50",
        "cifar-buckets-rank-major", "async-buckets",
        "async-buckets-rank-major", "fsdp-rank-major",
        "allreduce-hierarchical-dcn2", "allreduce-pallas-dcn2",
        "cifar-dcn2", "allreduce-pallas-dcn2-process-world",
        "longcontext-ring-flash-rank-major", "longcontext-ulysses-world",
        "moe-top2-rank-major", "moe-world", "megatron-rank-major",
        "megatron-3d-interleaved-rank-major"])
def test_example_runs_and_loss_falls(name, argv):
    out = _main(name, argv)
    losses = out["losses"]
    assert len(losses) >= 2 and all(map(lambda v: v == v, losses))
    assert losses[-1] < losses[0], losses
    assert not tmpi.is_initialized()


@pytest.mark.parametrize("devices", [[], ["--devices", "2"]])
def test_async_example_overlap_matches_buckets(monkeypatch, devices):
    """``mnist_async_allreduce`` under ``TORCHMPI_TPU_GRADSYNC_OVERLAP=auto``
    (the overlapped sync) gives the bucketed run's losses bitwise (the
    stock route's sum over ranks does not depend on the buckets)."""
    argv = ["--steps", "21", "--batch-size", "64"] + devices
    plain = _main("mnist_async_allreduce", argv)
    monkeypatch.setenv("TORCHMPI_TPU_GRADSYNC_OVERLAP", "auto")
    over = _main("mnist_async_allreduce", argv)
    assert over["overlap"] and not plain["overlap"]
    assert over["losses"] == plain["losses"]
    assert over["accuracy"] == plain["accuracy"]


def test_eager_loss_reduces_through_the_staged_path():
    """``mnist_allreduce --eager-loss``: the logging loss through the
    host-staged rank-major allreduce, the same losses as without it (the
    mean of n equal values) and a LOSS-DIGEST of them."""
    argv = ["--steps", "3", "--batch-size", "64", "--devices", "2"]
    plain = _main("mnist_allreduce", argv)
    eager = _main("mnist_allreduce", argv + ["--eager-loss"])
    assert len(eager["loss_digest"]) == 32
    assert eager["losses"] == pytest.approx(plain["losses"], rel=1e-6)


@pytest.mark.parametrize("name,argv", [
    ("mnist_downpour", ["--steps", "21", "--batch-size", "32", "--workers",
                        "2"]),
    ("mnist_easgd", ["--steps", "21", "--batch-size", "32", "--workers",
                     "2"]),
    ("alexnet_downpour", ["--steps", "4", "--batch-size", "4"]),
    ("checkpoint_resume", ["--steps", "20", "--batch-size", "32"]),
], ids=["downpour", "easgd", "alexnet-downpour", "checkpoint-resume"])
def test_ps_example_runs(name, argv):
    """The parameter-server examples (worker threads sharing one server)
    and the checkpoint example a few steps: finite losses, worker 0's
    falling in the MNIST ones (AlexNet's 4 steps at lr 3e-4 are too few to
    say), the server's op count, and the resumed run below its loss at
    the crash (``checkpoint_resume`` raises otherwise)."""
    out = _main(name, argv)
    losses = out["losses"]
    assert losses and all(v == v for v in losses)
    if name.startswith("mnist"):
        assert losses[-1] < losses[0], losses
    if name == "checkpoint_resume":
        assert out["resume_step"] == 10 and out["final"] < out["pre_crash"]
    else:
        assert out["ops_served"] > 0 and 0.0 <= out["accuracy"] <= 1.0
    assert not tmpi.is_initialized()


@pytest.mark.parametrize("name,argv,item", [
    ("mnist_allreduce", ["--dcn", "2"], "item 4"),
    ("mnist_allreduce", ["--backend", "hierarchical"], "item 4"),
    ("mnist_allreduce", ["--restart-loop", "--eager-loss", "--steps", "6",
                         "--save-every", "2", "--batch-size", "32"],
     "item 13"),
    ("checkpoint_resume", ["--restart-loop", "--steps", "8", "--save-every",
                           "2", "--crash-at", "5", "--batch-size", "32"],
     "item 13"),
])
def test_unported_flags_raise_by_name(name, argv, item, tmp_path,
                                      monkeypatch, capsys):
    """The flags of once-unported machinery run now.  Item 4, the
    two-level world: ``--dcn 2`` alone in a world of one process (the flag
    factors rank-major ranks), ``--backend hierarchical`` there warned
    once and run on the stock route.  Item 13, the restart loop
    (``utils/restart.py``): ``--restart-loop`` recovers from one failure
    and prints JAX's RESTARTS / RECOVERED-STEP / LOSS-DIGEST lines, the
    digest equal to a run without the failure: for ``mnist_allreduce``
    the JAX watchdog recipe (a ``stall`` at the eager loss's staged
    gather of step 3 under ``watchdog="break"``, broken into a
    ``CollectiveHangError``), for ``checkpoint_resume`` ``--crash-at``."""
    if item == "item 13":
        clean_argv = list(argv)
        if name == "mnist_allreduce":
            plan = tmp_path / "stall.json"
            plan.write_text(json.dumps({"version": 1, "seed": 7, "rules": [
                {"site": "host_staged.gather", "kind": "stall",
                 "after": 3, "max_hits": 1}]}))
            monkeypatch.setenv("TORCHMPI_TPU_FAULTS", str(plan))
            monkeypatch.setenv("TORCHMPI_TPU_WATCHDOG", "break")
            monkeypatch.setenv("TORCHMPI_TPU_WATCHDOG_DEADLINE", "0.3")
        else:
            clean_argv = argv[:-4] + argv[-2:]  # without --crash-at 5
        try:
            out = _main(name, argv)
        finally:
            for k in ("TORCHMPI_TPU_FAULTS", "TORCHMPI_TPU_WATCHDOG",
                      "TORCHMPI_TPU_WATCHDOG_DEADLINE"):
                monkeypatch.delenv(k, raising=False)
        text = capsys.readouterr().out
        assert "RESTARTS 1" in text
        assert "RECOVERED-STEP 2" in text if name == "mnist_allreduce" \
            else "RECOVERED-STEP 4" in text
        assert f"LOSS-DIGEST {out['loss_digest']}" in text
        assert out["restart_info"]["restarts_used"] == 1
        clean = _main(name, clean_argv)
        assert "RESTARTS 0" in capsys.readouterr().out
        assert clean["restart_info"]["restarts_used"] == 0
        assert out["loss_digest"] == clean["loss_digest"]
        return
    if item == "item 4":
        tsel._warned_fallbacks.clear()
        short = ["--steps", "3", "--batch-size", "32"]
        if "hierarchical" in argv:
            with pytest.warns(RuntimeWarning, match="flat world"):
                out = _main(name, argv + short)
        else:
            out = _main(name, argv + short)
        assert all(v == v for v in out["losses"])


@pytest.mark.slow
@pytest.mark.parametrize("name,argv", [
    ("mnist_sequential", []), ("mnist_allreduce", []),
    ("mnist_allreduce", ["--devices", "8", "--dcn", "2", "--backend",
                         "hierarchical"]),
    ("mnist_async_allreduce", []), ("mnist_fsdp", ["--devices", "4"]),
    ("cifar_resnet20", []), ("cifar_resnet20", ["--zero", "3"])])
def test_example_converges(name, argv):
    """The full-length default runs to their accuracy bars (each raises
    AssertionError below it)."""
    out = _main(name, argv)
    assert out["accuracy"] > (0.85 if name.startswith("cifar") else 0.9)


@pytest.mark.slow
def test_longcontext_example_converges():
    """``longcontext_lm --devices 8 --dcn 2 --attn ring`` (the sequence over
    4 ici ranks, the batch over 2 dcn ranks, 80 steps) to the JAX bar:
    the last loss below 0.35 of the first (``main`` raises otherwise)."""
    out = _main("longcontext_lm", ["--devices", "8", "--dcn", "2", "--attn",
                                   "ring"])
    assert out["learned"] and out["last"] < 0.35 * out["first"]


@pytest.mark.slow
def test_moe_example_converges():
    """``moe_lm --devices 8 --top-k 2`` (8 experts over ici, GShard
    combine, 60 steps) to the JAX bar: the last loss below 0.7 of the
    first (``main`` raises otherwise)."""
    out = _main("moe_lm", ["--devices", "8", "--top-k", "2"])
    assert out["learned"] and out["last"] < 0.7 * out["first"]


@pytest.mark.slow
def test_megatron_example_converges():
    """``megatron_pipeline --devices 8 --dp 2`` (pp 2 x dp 2 x tp 2, 120
    steps) to the JAX bar: the last loss below 0.2 of the first (``main``
    raises otherwise)."""
    out = _main("megatron_pipeline", ["--devices", "8", "--dp", "2"])
    assert out["learned"] and out["drop"] < 0.2


def _dense_block(x, w, H):
    """One full (unsharded) Megatron block with unit layer norms: the
    sequential oracle."""
    def ln(h):
        mu = h.mean(-1, keepdim=True)
        var = ((h - mu) ** 2).mean(-1, keepdim=True)
        return (h - mu) * torch.rsqrt(var + 1e-6)

    B, T, D = x.shape
    q, k, v = ((ln(x) @ w[n]).reshape(B, T, H, D // H)
               for n in ("wq", "wk", "wv"))
    s = torch.einsum("bthd,bshd->bhts", q, k) / (D // H) ** 0.5
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(),
                      float("-inf"))
    ctx = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
    x = x + ctx.reshape(B, T, D) @ w["wo"]
    return x + torch.nn.functional.gelu(ln(x) @ w["w1"]) @ w["w2"]


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
def test_megatron_step_gradient_is_the_mean_loss_gradient(schedule):
    """The example's synced gradient carries no factor: on pp 2 x dp 2 x
    tp 2 rank-major, every rank's gradient is its shard of the gradient
    of the mean over the dp groups of the JAX loss (the last stage's
    squared error over the target's size), through the blocks applied in
    order, unsharded (the example's widths, T 8, M 4)."""
    from torchmpi_tpu_torch.examples import megatron_pipeline as mp

    S, n_dp, n_tp, B, T, M = 2, 2, 2, 2, 8, 4
    V = 2 if schedule == "interleaved" else 1
    H, D, F = n_tp, 8 * n_tp, 16 * n_tp
    blocks = [mp.dense_block(1 + l, D, F) for l in range(S * V)]
    rng = np.random.RandomState(0)
    xs = rng.randn(n_dp, M, B, T, D).astype(np.float32)
    ys = (rng.randn(n_dp, M, B, T, D) * 0.3).astype(np.float32)
    tmpi.init(tmpi.Config(mesh_shape={"pp": S, "dp": n_dp, "tp": n_tp}),
              device="cpu")
    dev = torch.device("cpu")
    params = mp.rank_major_params(mp.staged_weights(blocks, S, n_tp),
                                  n_dp, dev)
    rows = [d for _ in range(S) for d in range(n_dp) for _ in range(n_tp)]
    step = mp.make_train_step(mp.make_stage_fn(H, D, dev, rank_major=True),
                              S, schedule=schedule, lr=0.0, rank_major=True)
    loss, grads = step(params, torch.from_numpy(xs[rows]),
                       torch.from_numpy(ys[rows]))

    full = [{k: torch.from_numpy(v).requires_grad_() for k, v in b.items()}
            for b in blocks]
    total = 0.0
    for g in range(n_dp):
        for m in range(M):
            h = torch.from_numpy(xs[g, m])
            for w in full:
                h = _dense_block(h, w, H)
            total = total + ((h - torch.from_numpy(ys[g, m])) ** 2).sum()
    ref_loss = total / (M * B * T * D) / n_dp
    ref_loss.backward()
    np.testing.assert_allclose(loss.numpy(), float(ref_loss.detach()),
                               rtol=1e-5)
    for k in mp.KEYS:
        got = grads[k].reshape(S, n_dp, n_tp, V, *grads[k].shape[2:])
        for p in range(S):
            for v in range(V):
                want = full[v * S + p][k].grad
                for d in range(n_dp):
                    shards = [got[p, d, t, v, 0] for t in range(n_tp)]
                    cat = torch.cat(shards, 0 if k in ("wo", "w2") else 1)
                    np.testing.assert_allclose(
                        cat.numpy(), want.numpy(), rtol=1e-4,
                        atol=1e-5 * float(want.abs().max()))


@pytest.mark.slow
@pytest.mark.parametrize("name,bar", [("mnist_downpour", 0.9),
                                      ("mnist_easgd", 0.9),
                                      ("alexnet_downpour", 0.2)])
def test_ps_example_converges(name, bar):
    """The parameter-server examples' default runs to the JAX examples'
    bars (MNIST > 0.9; AlexNet's center above twice chance, 2 / 10)."""
    assert _main(name, [])["accuracy"] > bar
