"""The serving layer's telemetry (``tm_serving_*``) against the JAX
package's: the SLO-telemetry and shed-counter cases of JAX
``tests/test_serving.py::test_slo_metrics_and_obs_tool_slo`` (:354) and
``tests/test_serving_fleet.py::test_slo_shed_counters_and_obs_tool_fleet_line``
(:465), on the port's server at the JAX fixture's widths (vocab 41, embed
32, depth 2, 4 heads of 8, RoPE), its flax weights loaded into the port's
model.

Both servers run the same trace on a virtual clock (a fixed tick, or work
units), so the counters, the latency histograms (TTFT and inter-token, in
microseconds), the queue-depth and occupancy samples, and ``tool slo``'s
text are the same on both sides.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from _torch_world import module_group
from torchmpi_tpu import serving as jserving
from torchmpi_tpu.models import TransformerLM as JaxLM
from torchmpi_tpu_torch import obs as tobs
from torchmpi_tpu_torch import serving, weights as tweights
from torchmpi_tpu_torch.models import TransformerLM
from torchmpi_tpu_torch.obs import tool

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 41
CFG = dict(vocab=VOCAB, embed=32, depth=2, num_heads=4, head_dim=8,
           max_len=64, pos_emb="rope")


@pytest.fixture(scope="module", autouse=True)
def _group():
    with module_group():
        yield


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(**CFG)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    pm = TransformerLM(**CFG, device="cpu")
    pm.load_state_dict(tweights.from_flax_params(params, pm))
    return jm, params, pm


@pytest.fixture()
def both(tmp_path):
    from torchmpi_tpu import obs as jobs

    jmpi.stop()
    tmpi.stop()
    jmpi.init(jmpi.Config(dcn_size=1, obs="metrics",
                          obs_dir=str(tmp_path / "jax")))
    tmpi.init(tmpi.Config(obs="metrics", obs_dir=str(tmp_path / "port")),
              device="cpu")
    jobs.reset()
    tobs.reset()
    yield jobs, tmp_path
    for o in (jobs, tobs):
        o.deactivate()
        o.reset()
    tmpi.stop()
    jmpi.stop()


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "_jax_obs_tool", os.path.join(_REPO, "scripts", "obs_tool.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serving(snap):
    """The ``tm_serving_*`` series of a snapshot, {(name, labels): ...}."""
    out = {}
    for r in snap:
        if not r["name"].startswith("tm_serving_"):
            continue
        key = (r["name"], tuple(sorted(r["labels"].items())))
        out[key] = (r["value"] if r["kind"] == "counter"
                    else (r["buckets"], r["count"], r["sum"]))
    return out


def test_slo_metrics_and_tool_slo(lm, both, capsys):
    jobs, tmp_path = both
    jm, params, pm = lm
    prompts = np.random.RandomState(7).randint(
        0, VOCAB, size=(6, 5)).astype(np.int32)
    runs = []
    for srv_mod, srv in (
            (jserving, jserving.Server(jm, params, replicas=1, slots=4,
                                       slot_tokens=32)),
            (serving, serving.Server(pm, replicas=1, slots=4,
                                     slot_tokens=32))):
        reqs = [srv_mod.Request(f"s{i}", prompts[i], max_new=4 + i,
                                arrival_s=0.001 * i) for i in range(6)]
        srv.run_trace(reqs, tick_seconds=0.001)
        runs.append(reqs)
    reg = tobs.registry()
    assert reg.counter_total("tm_serving_requests_total") == 6
    assert reg.counter_total("tm_serving_completed_total") == 6
    assert reg.counter_total("tm_serving_tokens_total") == \
        sum(len(r.tokens) for r in runs[1])
    names = {r["name"] for r in reg.snapshot()}
    assert {"tm_serving_ttft_us", "tm_serving_itl_us",
            "tm_serving_queue_depth",
            "tm_serving_slot_occupancy_pct"} <= names
    assert _serving(reg.snapshot()) == _serving(jobs.registry().snapshot())
    assert [e for e in tobs.recorder().events() if e[2] == "step"]
    port_paths = tobs.dump(str(tmp_path / "port"))
    jax_paths = jobs.dump(str(tmp_path / "jax"))
    outs = []
    for t, path in ((tool, port_paths[0]), (_jax_tool(), port_paths[0]),
                    (_jax_tool(), jax_paths[0])):
        assert t.main(["slo", path]) == 0
        outs.append(capsys.readouterr().out.replace(path, "<dump>"))
    assert outs[0] == outs[1] == outs[2]
    out = outs[0]
    assert "TTFT" in out and "inter-token" in out and "p99" in out
    assert "replica0" in out and "prefill_compiles" in out
    empty = tmp_path / "empty.jsonl"
    empty.write_text(json.dumps(
        {"kind": "meta", "stream": "metrics", "host": "x"}) + "\n")
    assert tool.main(["slo", str(empty)]) == 2


def test_slo_shed_counters_and_tool_fleet_line(lm, both, capsys):
    jobs, tmp_path = both
    jm, params, pm = lm
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, VOCAB, size=8).astype(np.int32)
               for _ in range(40)]
    dones = []
    for srv_mod, srv in (
            (jserving, jserving.Server(jm, params, replicas=1, slots=2,
                                       slot_tokens=32, slo_ttft_us=1.0)),
            (serving, serving.Server(pm, replicas=1, slots=2,
                                     slot_tokens=32, slo_ttft_us=1.0))):
        reqs = [srv_mod.Request(f"r{i}", prompts[i], max_new=4,
                                arrival_s=i * 0.5) for i in range(40)]
        dones.append(srv.run_trace(reqs, unit_seconds=1.0))
    done = dones[1]
    shed = [r for r in done if r.shed]
    served = [r for r in done if not r.shed]
    assert len(done) == 40 and shed and served
    assert all("slo" in r.error and r.tokens == [] for r in shed)
    reg = tobs.registry()
    assert reg.counter_total("tm_serving_shed_total") == len(shed)
    assert reg.counter_total("tm_serving_admitted_total") == len(served)
    assert [r.shed for r in done] == [r.shed for r in dones[0]]
    assert _serving(reg.snapshot()) == _serving(jobs.registry().snapshot())
    paths = tobs.dump(str(tmp_path / "port"))
    assert tool.main(["slo", paths[0]]) == 0
    out = capsys.readouterr().out
    assert "fleet:" in out and "shed=" in out and "queue_depth" in out
    assert _jax_tool().main(["slo", paths[0]]) == 0
    assert capsys.readouterr().out == out
