"""The trace-time analysis of the port against the JAX package's
(tests/test_analysis.py), the second half: the S1 / S2 cases on the aten
graph of ``make_fx``, the tool over the fixture files, ``plan_tool lint``
and ``dump-live``, and the hook on the port's own paths (the first half
and the conventions: tests/test_torch_analysis.py).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from torchmpi_tpu import analysis as janalysis
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import analysis, collectives, fusion, planner, runtime
from torchmpi_tpu_torch.parallel import gradsync

from _torch_world import module_group
from test_torch_analysis import _keys, _port_params, _port_zero_step

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def group():
    with module_group():
        yield


@pytest.fixture(autouse=True)
def rt():
    tmpi.stop()
    tmpi.init(device="cpu")
    analysis.reset_captured()
    yield
    analysis.reset_captured()
    tmpi.stop()


# ---------------------------------------------------------------------------
# S1 / S2: cache writes (the aten graph of make_fx)
# ---------------------------------------------------------------------------

CACHE = torch.zeros(4, 16, 8)


def _jax_s1(clamp):
    cache = jax.ShapeDtypeStruct((4, 16, 8), jnp.float32)
    row = jax.ShapeDtypeStruct((1, 1, 8), jnp.float32)
    pos = jax.ShapeDtypeStruct((), jnp.int32)

    def step_loop(c, r, p):
        if clamp:
            p = jnp.clip(p, 0, c.shape[1] - 1)

        def body(cc, _):
            return lax.dynamic_update_slice(cc, r, (0, p, 0)), ()

        out, _ = lax.scan(body, c, None, length=2)
        return out

    return janalysis.check(step_loop, cache, row, pos, rules=["S1"])


def _port_s1(clamp):
    def step_loop(c, r, p):
        if clamp:
            p = torch.clamp(p, 0, c.shape[1] - 1)
        for _ in range(2):
            c[:, p] = r
        return c

    return analysis.check(step_loop, CACHE.clone(), torch.zeros(4, 1, 8),
                          torch.zeros(1, dtype=torch.long), rules=["S1"])


def test_torch_s1_unclamped_carried_cache_write_errors():
    found = _port_s1(clamp=False)
    assert {f.rule for f in found} == {"S1"}
    assert found[0].severity == analysis.ERROR
    assert "carried cache buffer" in found[0].message
    assert _keys(found) == _keys(_jax_s1(clamp=False))


def test_torch_s1_near_miss_clamped_write_passes():
    assert _jax_s1(clamp=True) == []
    assert _port_s1(clamp=True) == []


def test_torch_s2_inline_clip_warns_chokepoint_clears():
    """The per-row slot write: an inline clamp satisfies S1 but not the
    chokepoint discipline (S2 warning); ``clamp_slot_positions`` leaves
    the ``slot_clamp`` record and clears both."""
    from torchmpi_tpu.models.generate import clamp_slot_positions as jclamp
    from torchmpi_tpu_torch.models.generate import clamp_slot_positions

    def jwrite(c, u, s):
        return jax.vmap(
            lambda cc, uu, ss: lax.dynamic_update_slice(cc, uu, (ss, 0))
        )(c, u, s)

    jargs = (jax.ShapeDtypeStruct((4, 16, 8), jnp.float32),
             jax.ShapeDtypeStruct((4, 1, 8), jnp.float32),
             jax.ShapeDtypeStruct((4,), jnp.int32))
    jinline = janalysis.check(
        lambda c, u, s: jwrite(c, u, jnp.clip(s, 0, c.shape[1] - 1)),
        *jargs, rules=["S1", "S2"])
    assert janalysis.check(lambda c, u, s: jwrite(c, u, jclamp(
        s, c.shape[1])), *jargs, rules=["S1", "S2"]) == []

    def write(c, u, s):
        c[torch.arange(c.shape[0]), s] = u
        return c

    args = (CACHE.clone(), torch.zeros(4, 8),
            torch.zeros(4, dtype=torch.long))
    found = analysis.check(
        lambda c, u, s: write(c, u, torch.clamp(s, 0, c.shape[1] - 1)),
        *args, rules=["S1", "S2"])
    assert [f.rule for f in found] == ["S2"]
    assert found[0].severity == analysis.WARNING
    assert _keys(found) == _keys(jinline)
    assert analysis.check(lambda c, u, s: write(
        c, u, clamp_slot_positions(s, c.shape[1])), *args,
        rules=["S1", "S2"]) == []


def test_torch_s1_shipped_slot_decode_certifies():
    """The real serving tick's aten graph is S1 / S2 clean: every cache
    write of the decode provably in range, through the chokepoint."""
    import importlib

    gen = importlib.import_module("torchmpi_tpu_torch.models.generate")
    tmod = importlib.import_module("torchmpi_tpu_torch.models.transformer")
    model = tmpi.models.TransformerLM(
        vocab=50, embed=32, depth=1, num_heads=4, head_dim=8, max_len=32,
        pos_emb="rope", device="cpu",
        generator=torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 16)

    def tick(ks, vs, toks, pos):
        return gen.slot_decode_step(model, tmod.KVCache(ks, vs), toks,
                                    pos)[1]

    z = torch.zeros(2, dtype=torch.long)
    assert analysis.check(tick, cache.k, cache.v, z, z,
                          rules=["S1", "S2"]) == []
    # The graph holds the per-row cache writes the certificate covers.
    gm, records = analysis.trace_graph(tick, cache.k, cache.v, z, z)
    events = analysis.trace_slice_events(gm)
    assert [e.op for e in events if e.write] == ["index_put"] * 2
    assert all(e.safe and e.on_buffer for e in events if e.write)
    assert {r["kind"] for r in records} == {"slot_clamp"}


# ---------------------------------------------------------------------------
# The tool over the fixture files
# ---------------------------------------------------------------------------


def _run_tool(*args, timeout=240, device=("--device", "cpu")):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, os.path.join(_REPO, "torchmpi_tpu_torch",
                                      "analysis", "tool.py"), *device,
         *args],
        capture_output=True, text=True, timeout=timeout, cwd=_REPO,
        env=env)


def test_torch_cli_exits_nonzero_on_seeded_bad_fixtures():
    out = _run_tool("tests/_torch_analysis_bad.py", "--json")
    assert out.returncode == 1, out.stderr
    findings = json.loads(out.stdout)
    assert {"D1", "D2", "S1", "S2"} <= {f["rule"] for f in findings}


def test_torch_cli_exits_zero_on_clean_fixtures():
    out = _run_tool("tests/_torch_analysis_clean.py")
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_torch_cli_runs_declared_targets_on_the_card_by_default():
    # With no --device the declared targets run on the card: with none
    # visible the tool says so and exits 2 (a target could not be
    # analyzed), never silently on the CPU.
    out = _run_tool("tests/_torch_analysis_clean.py", device=())
    assert out.returncode == 2, out.stdout + out.stderr
    assert "no CUDA device" in out.stderr


@pytest.mark.slow
def test_torch_cli_clean_bill_on_example_entry_points():
    # Two example entry points run under the runtime hook: the library's
    # own training paths lint clean.
    for example, args in [
        ("torchmpi_tpu_torch/examples/mnist_allreduce.py",
         "--device cpu --devices 4 --steps 2"),
        ("torchmpi_tpu_torch/examples/mnist_sequential.py",
         "--device cpu --steps 2"),
    ]:
        out = _run_tool(example, "--args", args, timeout=600)
        assert out.returncode == 0, (example, out.stdout, out.stderr)


# ---------------------------------------------------------------------------
# plan_tool lint and dump-live
# ---------------------------------------------------------------------------


def test_torch_plan_tool_lint_divergence_and_orphans(tmp_path):
    from torchmpi_tpu_torch.tuning import PlanCache, PlanEntry

    a = PlanCache(str(tmp_path / "a.json"))
    b = PlanCache(str(tmp_path / "b.json"))
    key = "cpu|dcn:2,ici:4|allreduce|float32|b20"
    a.put(key, PlanEntry(backend="pallas"))
    b.put(key, PlanEntry(backend="xla"))  # PL1: cross-host divergence
    # PL2: bucket 4 sits 16 buckets from its only neighbour.
    a.put("cpu|dcn:2,ici:4|broadcast|float32|b4", PlanEntry(backend="xla"))
    a.put("cpu|dcn:2,ici:4|broadcast|float32|b20",
          PlanEntry(backend="xla"))
    assert a.save() and b.save()

    def run(*files):
        return subprocess.run(
            [sys.executable, "-m", "torchmpi_tpu_torch.tuning.plan_tool",
             "lint", *files, "--json"], capture_output=True, text=True,
            timeout=240, cwd=_REPO)

    out = run(a.path, b.path)
    assert out.returncode == 1, out.stderr  # divergence = error
    assert {f["rule"] for f in json.loads(out.stdout)} == {"PL1", "PL2"}
    out = run(a.path)  # one file: PL2 only, a warning: exit 0
    assert out.returncode == 0, out.stdout + out.stderr
    assert {f["rule"] for f in json.loads(out.stdout)} == {"PL2"}


def test_torch_plan_tool_dump_live(tmp_path):
    script = tmp_path / "warm.py"
    script.write_text(
        "import torch\n"
        "import torchmpi_tpu_torch as mpi\n"
        "mpi.init(device='cpu', analysis='warn')\n"
        "x = torch.ones(4, 1024)\n"
        "for _ in range(3):\n"
        "    mpi.allreduce_rank_major(x)\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.tuning.plan_tool",
         "dump-live", str(script), "--json"], capture_output=True,
        text=True, timeout=240, cwd=_REPO, env=env)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    (row,) = got["plans"]
    assert (row["kind"], row["op"], row["hits"], row["analysis"]) == \
        ("eager", "allreduce", 2, "warn")
    assert got["stats"]["misses"] == 1


# ---------------------------------------------------------------------------
# The hook on the port's own paths
# ---------------------------------------------------------------------------


def test_torch_hook_refuses_d1_loss_before_the_first_call():
    model = torch.nn.Linear(8, 8)
    calls = []

    def loss_fn(m, xb):
        calls.append(1)
        if runtime.rank() == 0:
            collectives.allreduce_in_axis(xb)
        return m(xb).sum()

    tmpi.set_config(analysis="error")
    step = gradsync.data_parallel_step_rank_major(
        model, torch.optim.SGD(model.parameters(), lr=0.1), loss_fn, 2)
    with pytest.raises(analysis.AnalysisError, match="D1"):
        step(torch.ones(4, 8))
    assert calls == []


def test_torch_hook_refuses_stale_spec_at_the_leg():
    """A ZeRO update over a stale spec, wrapped by the hook: refused at
    the leg's dispatch, before its reduce-scatter launches."""
    stale = fusion.FusedSpec(_port_params(), 4, max_bytes=0)
    step = analysis.wrap_step(_port_zero_step(stale), label="zero_stale",
                              mode="error")
    launched = []
    real = collectives._eager
    collectives._eager = lambda *a, **k: (launched.append(a[0]),
                                          real(*a, **k))[1]
    try:
        with pytest.raises(analysis.AnalysisError, match="C1"):
            step(torch.zeros(8, stale.shard))
    finally:
        collectives._eager = real
    assert launched == []


def test_torch_eager_verbs_check_once_a_plan_build():
    tmpi.set_config(analysis="warn")
    x = torch.ones(8, 16)
    for _ in range(3):
        tmpi.allreduce_rank_major(x)
    found = analysis.captured_findings()
    assert [f.rule for f in found] == ["P2"] or found == []
    (row,) = [r for r in planner.describe() if r["kind"] == "eager"]
    assert row["analysis"] == "warn" and row["hits"] == 2
    n = len(analysis.captured_findings())
    tmpi.allreduce_rank_major(x)  # a hit: no check
    assert len(analysis.captured_findings()) == n


def test_torch_off_imports_nothing_of_analysis():
    code = ("import sys, torch\n"
            "import torchmpi_tpu_torch as mpi\n"
            "from torchmpi_tpu_torch.parallel import gradsync\n"
            "mpi.init(device='cpu')\n"
            "m = torch.nn.Linear(4, 4)\n"
            "step = gradsync.data_parallel_step_rank_major(\n"
            "    m, torch.optim.SGD(m.parameters(), lr=0.1),\n"
            "    lambda mm, x: mm(x).sum(), 2)\n"
            "step(torch.ones(2, 4))\n"
            "mpi.allreduce_rank_major(torch.ones(2, 4))\n"
            "print(sorted(k for k in sys.modules\n"
            "             if k.startswith('torchmpi_tpu_torch.analysis')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=_REPO,
                         env=dict(os.environ, PYTHONPATH=_REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
