"""The port's telemetry layer (torchmpi_tpu_torch.obs) against the JAX
package's: the registry, the flight recorder, the dump and its SIGTERM
path, and the operator tool (JAX ``tests/test_obs.py`` :56-290).

The registry and the recorder are held to the JAX package's on the same
call sequences (snapshots, Prometheus text and flight records equal, but
for timestamps).  The tool is held to JAX's ``scripts/obs_tool.py``: the
same dump files go through both and every command prints the same text
with the same exit code.  Nothing here needs a runtime or a card.
"""

import importlib
import importlib.util
import json
import os
import signal
import time

import pytest

from torchmpi_tpu_torch import obs
from torchmpi_tpu_torch.obs import tool

# The modules, not the packages' accessor functions of the same names.
jrecorder = importlib.import_module("torchmpi_tpu.obs.recorder")
jregistry = importlib.import_module("torchmpi_tpu.obs.registry")
recorder = importlib.import_module("torchmpi_tpu_torch.obs.recorder")
registry = importlib.import_module("torchmpi_tpu_torch.obs.registry")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    """The JAX package's scripts/obs_tool.py, loaded by path (stdlib only)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_obs_tool", os.path.join(_REPO, "scripts", "obs_tool.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(capsys, *argv):
    """(rc, stdout) of JAX's tool and of the port's on ``argv``."""
    out = []
    for t in (_jax_tool(), tool):
        rc = t.main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


class _Mesh:
    """A JAX-style mesh: a ``shape`` dict (what ``obs.mesh_label`` reads
    from anything that is not a communicator)."""

    def __init__(self, **shape):
        self.shape = shape


def _no_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def _fill(r):
    r.counter_inc("c", op="allreduce")
    r.counter_inc("c", 4, op="allreduce")
    r.counter_inc("c", op="broadcast")
    r.hist_observe("h", 100)   # floor(log2(100)) = 6
    r.hist_observe("h", 127)
    r.hist_observe("h", 128)   # bucket 7
    inc = r.counter_handle("k_total", op="x", kind="eager")
    inc()
    inc(2)
    obs_h = r.hist_handle("hh", op="x")
    obs_h(3.0)


def test_registry_counters_and_hist_match_jax():
    r, j = registry.Registry(), jregistry.Registry()
    _fill(r)
    _fill(j)
    assert r.counter("c", op="allreduce") == 5
    assert r.counter_total("c") == 6
    snap = r.snapshot()
    hist = [s for s in snap if s["name"] == "h"][0]
    assert hist["buckets"] == {"6": 2, "7": 1}
    assert hist["count"] == 3 and hist["sum"] == 355.0
    assert snap == j.snapshot()
    assert r.names() == j.names()


def test_prometheus_text_matches_jax():
    r, j = registry.Registry(), jregistry.Registry()
    for reg in (r, j):
        reg.counter_inc("tm_x_total", 3, op="a")
        reg.hist_observe("tm_y", 100, op="a")
    text = r.to_prometheus()
    assert '# TYPE tm_x_total counter' in text
    assert 'tm_x_total{op="a"} 3' in text
    assert 'tm_y_bucket{le="128",op="a"} 1' in text
    assert 'tm_y_bucket{le="+Inf",op="a"} 1' in text
    assert 'tm_y_count{op="a"} 1' in text
    assert text == j.to_prometheus()


@pytest.mark.parametrize("value", [0, 1, 2, 3, 1023, 1024, 2 ** 40 + 5])
def test_log2_bucket_matches_jax(value):
    assert registry.log2_bucket(value) == jregistry.log2_bucket(value)


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------


def test_ring_wraparound_matches_jax():
    r, j = recorder.FlightRecorder(8), jrecorder.FlightRecorder(8)
    for rec in (r, j):
        for i in range(20):
            rec.append("eager", f"op{i}", i)
    assert len(r) == 8 and r.total == 20 and r.dropped == 12
    evs = r.events()
    assert [e[0] for e in evs] == list(range(12, 20))
    assert evs[0][3] == "op12" and evs[-1][3] == "op19"
    recs = r.to_records()
    assert recs[0]["kind"] == "event" and recs[0]["ev"] == "eager"
    assert _no_ts(recs) == _no_ts(j.to_records())


def test_best_effort_snapshot_survives_held_locks():
    """The SIGTERM dump path must not deadlock when the signal lands while
    the interrupted frame holds a registry or recorder lock."""
    r = registry.Registry()
    r.counter_inc("c", 3)
    fr = recorder.FlightRecorder(8)
    fr.append("eager", "allreduce", 64, "xla")
    r._lock.acquire()
    fr._lock.acquire()
    try:
        snap = r.snapshot(best_effort=True)
        assert snap[0]["value"] == 3
        evs = fr.events(best_effort=True)
        assert evs[0][3] == "allreduce"
    finally:
        r._lock.release()
        fr._lock.release()


def test_ring_resize_preserves_history():
    r = recorder.FlightRecorder(8)
    for i in range(10):
        r.append("eager", f"op{i}", i)
    big = r.resized(32)
    assert big.total == 10 and big.size == 32
    assert [e[0] for e in big.events()] == list(range(2, 10))
    assert big.events()[-1][3] == "op9"
    small = r.resized(4)
    assert [e[0] for e in small.events()] == [6, 7, 8, 9]
    small.append("eager", "next", 0)
    assert small.events()[-1][0] == 10


# ---------------------------------------------------------------------------
# Activation, dump, SIGTERM
# ---------------------------------------------------------------------------


@pytest.fixture()
def active(tmp_path):
    obs.activate("metrics", out_dir=str(tmp_path), host="t")
    obs.reset()
    yield tmp_path
    obs.deactivate()
    obs.reset()


def test_dump_writes_both_streams_and_prom(active, capsys):
    obs.record_eager("allreduce", 64, "xla", _Mesh(dcn=1, ici=8),
                     dtype="torch.float32")
    obs.record_barrier("b")
    prom = active / "m.prom"
    paths = obs.dump(prom_path=str(prom))
    assert [os.path.basename(p) for p in paths] == [
        "metrics_hostt.jsonl", "flight_hostt.jsonl", "m.prom"]
    meta, recs = tool.load_jsonl(paths[0])
    assert meta["stream"] == "metrics" and meta["mode"] == "metrics"
    by = {(r["name"], tuple(sorted(r["labels"].items()))): r for r in recs}
    key = ("tm_collectives_total", (
        ("backend", "xla"), ("dtype", "float32"), ("mesh", "dcn:1,ici:8"),
        ("nbytes_bucket", "b6"), ("op", "allreduce")))
    assert by[key]["value"] == 1
    fmeta, frecs = tool.load_jsonl(paths[1])
    assert fmeta["ring"] == obs.DEFAULT_RING and fmeta["total"] == 2
    assert [r["ev"] for r in frecs] == ["eager", "barrier"]
    assert 'tm_barriers_total 1' in prom.read_text()
    # Both tools read the files the same way.
    got = _both(capsys, "dump", *paths[:2])
    assert got[0] == got[1] and got[0][0] == 0


def test_sigterm_dump(tmp_path):
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        obs.activate("trace", out_dir=str(tmp_path), host="sig")
        obs.reset()
        obs.recorder().append("eager", "allreduce", 64, "xla")
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        # The handler dumped, then chained to the pre-activation one.
        assert hits == [signal.SIGTERM]
        fpath = tmp_path / "flight_hostsig.jsonl"
        lines = [json.loads(ln) for ln in fpath.read_text().splitlines()]
        assert lines[0]["kind"] == "meta" and lines[0]["stream"] == "flight"
        assert any(r.get("op") == "allreduce" for r in lines[1:])
    finally:
        obs.deactivate()
        obs.reset()
        signal.signal(signal.SIGTERM, prev)
    # deactivate restored the pre-activation handler.
    assert signal.getsignal(signal.SIGTERM) is not obs._on_sigterm


def test_activate_resizes_ring_keeping_history(tmp_path):
    obs.activate("metrics", out_dir=str(tmp_path), ring_size=8)
    try:
        obs.reset()
        for i in range(5):
            obs.recorder().append("eager", f"op{i}", i)
        obs.activate("metrics", ring_size=16)
        assert obs.recorder().size == 16 and obs.recorder().total == 5
        assert obs.mode() == "metrics" and obs.active()
        with pytest.raises(ValueError, match="metrics|trace"):
            obs.activate("off")
    finally:
        obs.deactivate()
        obs.reset()
    assert obs.mode() == "off" and not obs.active()


def test_mesh_label_reads_a_communicator():
    """``axis:size`` of a communicator's stack of n (the JAX label of a
    Mesh), of a shape dict, and "unknown" rather than an error."""
    import torchmpi_tpu_torch as tmpi
    from torchmpi_tpu_torch import runtime

    comm = runtime.Communicator("world", ("dcn", "ici"), None, [0], [1, 1])
    tmpi.stop()
    assert obs.mesh_label(comm, 8) == "dcn:1,ici:8"
    assert obs.mesh_label(_Mesh(pp=2, tp=4)) == "pp:2,tp:4"
    assert obs.mesh_label(object()) == "unknown"


# ---------------------------------------------------------------------------
# The operator tool against the JAX package's
# ---------------------------------------------------------------------------


def _write_flight(path, host, records):
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "meta", "stream": "flight",
                            "host": host, "mode": "trace"}) + "\n")
        for r in records:
            f.write(json.dumps(r) + "\n")


def _mk_stream(ops):
    r = recorder.FlightRecorder(64)
    for op, nbytes in ops:
        r.append("eager", op, nbytes, "xla", "m")
    return r.to_records()


def test_blame_divergence(tmp_path, capsys):
    common = [("allreduce", 1024)] * 4
    a, b = tmp_path / "flight_host0.jsonl", tmp_path / "flight_host1.jsonl"
    _write_flight(a, 0, _mk_stream(common + [("broadcast", 2048)]))
    _write_flight(b, 1, _mk_stream(common + [("allreduce", 1024)]))
    (jrc, jout), (rc, out) = _both(capsys, "blame", str(a), str(b))
    assert rc == 1 and "DIVERGENCE at seq 4" in out
    assert "broadcast" in out and "allreduce" in out
    assert (rc, out) == (jrc, jout)


def test_blame_tail_hang(tmp_path, capsys):
    common = [("allreduce", 1024)] * 3
    a, b = tmp_path / "flight_host0.jsonl", tmp_path / "flight_host1.jsonl"
    _write_flight(a, 0, _mk_stream(common))
    _write_flight(b, 1, _mk_stream(common + [("reduce_scatter", 4096)]))
    (jrc, jout), (rc, out) = _both(capsys, "blame", str(a), str(b))
    assert rc == 1 and "continued past" in out and "reduce_scatter" in out
    assert (rc, out) == (jrc, jout)


def test_blame_aligned(tmp_path, capsys):
    s = _mk_stream([("allreduce", 1024)] * 3)
    a, b = tmp_path / "flight_host0.jsonl", tmp_path / "flight_host1.jsonl"
    _write_flight(a, 0, s)
    _write_flight(b, 1, s)
    (jrc, jout), (rc, out) = _both(capsys, "blame", str(a), str(b))
    assert rc == 0 and "aligned" in out
    assert (rc, out) == (jrc, jout)


def test_blame_wrapped_rings_align_on_overlap(tmp_path, capsys):
    big, small = recorder.FlightRecorder(64), recorder.FlightRecorder(4)
    for i in range(10):
        big.append("eager", f"op{i}", 8, "xla")
        small.append("eager", f"op{i}", 8, "xla")
    a, b = tmp_path / "flight_host0.jsonl", tmp_path / "flight_host1.jsonl"
    _write_flight(a, 0, big.to_records())
    _write_flight(b, 1, small.to_records())
    (jrc, jout), (rc, out) = _both(capsys, "blame", str(a), str(b))
    assert rc == 0 and "6..9" in out
    assert (rc, out) == (jrc, jout)


def _snap(path, val):
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "meta", "stream": "metrics",
                            "host": 0, "mode": "metrics"}) + "\n")
        f.write(json.dumps({"kind": "counter", "name": "tm_c_total",
                            "labels": {"op": "allreduce"},
                            "value": val}) + "\n")
        f.write(json.dumps({"kind": "hist", "name": "tm_h",
                            "labels": {}, "buckets": {"4": val},
                            "count": val, "sum": 16.0 * val}) + "\n")


def test_tool_agg_diff_and_malformed(tmp_path, capsys):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _snap(a, 2)
    _snap(b, 5)
    agg = tool.aggregate([str(a), str(b)])
    c = [r for r in agg if r["kind"] == "counter"][0]
    h = [r for r in agg if r["kind"] == "hist"][0]
    assert c["value"] == 7 and h["buckets"]["4"] == 7 and h["count"] == 7
    assert agg == _jax_tool().aggregate([str(a), str(b)])
    (jrc, jout), (rc, out) = _both(capsys, "diff", str(a), str(b))
    assert rc == 0 and "(+3)" in out and (rc, out) == (jrc, jout)
    (jrc, jout), (rc, out) = _both(capsys, "prom", str(a))
    assert rc == 0 and 'tm_c_total{op="allreduce"} 2' in out
    assert (rc, out) == (jrc, jout)
    bad = tmp_path / "bad.jsonl"
    bad.write_text("not json\n")
    (jrc, _), (rc, _) = _both(capsys, "dump", str(bad))
    assert rc == jrc == 1


def _serving_dump(path, host, ttft_us, itl_us, replica="r0"):
    r = registry.Registry()
    for v in ttft_us:
        r.hist_observe("tm_serving_ttft_us", v, replica=replica)
    for v in itl_us:
        r.hist_observe("tm_serving_itl_us", v, replica=replica)
    r.counter_inc("tm_serving_requests_total", len(ttft_us),
                  replica=replica)
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "meta", "stream": "metrics",
                            "host": host, "mode": "metrics"}) + "\n")
        for rec in r.snapshot():
            f.write(json.dumps(rec) + "\n")


def _flight_with_steps(path, host):
    r = recorder.FlightRecorder(64)
    for step in range(3):
        r.append("step", "data_parallel_step", step)
        r.append("plan", "allreduce", 0, "eager", "build")
        r.append("eager", "allreduce", 4096, "xla", "dcn:1,ici:4")
        r.append("eager_done", "allreduce", 4096, "xla", "dcn:1,ici:4")
        r.append("eager", "allreduce", 4096, "host", "dcn:1,ici:4")
        r.append("eager_done", "allreduce", 4096, "host", "dcn:1,ici:4")
    r.append("step", "data_parallel_step", 3)
    _write_flight(path, host, r.to_records())


def test_tool_matches_jax_on_every_command(tmp_path, capsys):
    """One set of dump files through both tools: dump, agg (and --json),
    prom, slo, blame, attribute (and --json, --diff) print the same text
    and exit with the same code."""
    d1, d2 = tmp_path / "before", tmp_path / "after"
    d1.mkdir()
    d2.mkdir()
    _serving_dump(d1 / "metrics_host0.jsonl", 0, [900, 1800, 5000],
                  [300, 310, 700, 20000])
    _serving_dump(d1 / "metrics_host1.jsonl", 1, [1000], [250],
                  replica="r1")
    _flight_with_steps(d1 / "flight_host0.jsonl", 0)
    _flight_with_steps(d1 / "flight_host1.jsonl", 1)
    _serving_dump(d2 / "metrics_host0.jsonl", 0, [1200], [400])
    _flight_with_steps(d2 / "flight_host0.jsonl", 0)
    metrics = sorted(str(p) for p in d1.glob("metrics_host*.jsonl"))
    flights = sorted(str(p) for p in d1.glob("flight_host*.jsonl"))
    for argv in (["dump", *metrics, *flights], ["agg", *metrics],
                 ["agg", "--json", *metrics], ["prom", *metrics],
                 ["slo", *metrics], ["blame", *flights],
                 ["attribute", str(d1)], ["attribute", "--json", str(d1)],
                 ["attribute", "--diff", str(d1), str(d2)],
                 ["attribute", "--diff", str(d1), str(d2), "--json"]):
        (jrc, jout), (rc, out) = _both(capsys, *argv)
        assert (rc, out) == (jrc, jout), argv
        assert rc == 0, (argv, out)


def test_tool_runs_as_module_and_blame_live_waits(tmp_path):
    import subprocess
    import sys

    _snap(tmp_path / "a.jsonl", 3)
    out = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.obs.tool", "prom",
         str(tmp_path / "a.jsonl")], capture_output=True, text=True,
        cwd=_REPO, timeout=120)
    assert out.returncode == 0 and 'tm_c_total{op="allreduce"} 3' in \
        out.stdout
    # blame --live: no lease yet is unusable input (2); a live watchdog's
    # lease, written by the port's watchdog, reads healthy (0).
    assert tool.main(["blame", "--live", str(tmp_path)]) == 2
    from torchmpi_tpu_torch import watchdog

    lease_dir = str(tmp_path / "leases")
    watchdog.activate("warn", deadline_s=5.0, lease_dir=lease_dir, rank=3)
    try:
        out = subprocess.run(
            [sys.executable, "-m", "torchmpi_tpu_torch.obs.tool", "blame",
             "--live", lease_dir], capture_output=True, text=True,
            cwd=_REPO, timeout=120)
    finally:
        watchdog.reset()
    assert out.returncode == 0, out.stdout + out.stderr
    assert "rank 3: LIVE idle" in out.stdout
    assert "all ranks healthy" in out.stdout


# ---------------------------------------------------------------------------
# utils.tracing: profiler ranges and a Chrome trace
# ---------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace_with_ranges(tmp_path):
    import torch

    from torchmpi_tpu_torch.utils import tracing

    with tracing.trace(str(tmp_path)) as d:
        with tracing.annotate("tm/step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        # A nested trace runs its body unprofiled instead of raising.
        with tracing.trace(str(tmp_path / "inner")) as inner:
            torch.ones(8).sum()
    assert d == str(tmp_path)
    doc = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "tm/step" in names
    assert not (tmp_path / "inner" / "trace.json").exists()
    assert inner == str(tmp_path / "inner")


def test_trace_never_masks_the_body_error(tmp_path):
    from torchmpi_tpu_torch.utils import tracing

    with pytest.raises(KeyError, match="body"):
        with tracing.trace(str(tmp_path)):
            raise KeyError("body")
    # The profiler was stopped: a new trace starts again.
    with tracing.trace(str(tmp_path / "again")):
        pass
    assert (tmp_path / "again" / "trace.json").exists()
