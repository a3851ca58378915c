"""The port's launcher (``python -m torchmpi_tpu_torch.launch``, the mpirun
analog) as JAX's tests/test_launch.py holds its own: two local processes
with torch's launcher environment, laid out for the CPU (``--device cpu``,
each script calling ``init(device="cpu")``), each an emulated host (the
two-level world's dcn axis is the process count) with working
collectives; and ``Config.mesh_shape`` across the two processes, a
pipeline forward over the process boundary matching its sequential
oracle.  Both ``slow``, as JAX marks them.  Beside them (not ``slow``):
the launcher's layout under each ``--device`` and that it hands the script
no device, and that a bare ``init()`` takes none from the environment."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    import torchmpi_tpu_torch as mpi

    dev = mpi.init(device="cpu")
    assert dev.type == "cpu", dev
    assert mpi.size() == 2, mpi.size()
    assert mpi.runtime.world_shape() == {{"dcn": 2, "ici": 1}}, \\
        mpi.runtime.world_shape()
    x = torch.full((3,), float(mpi.rank()))
    out = mpi.allreduce(x)
    assert torch.equal(out, torch.full((3,), 1.0)), out
    print(f"LAUNCHED rank={{mpi.rank()}} ok", flush=True)
    mpi.stop()
""")


def _launch(script, tmp_path, name):
    path = tmp_path / name
    path.write_text(script.format(repo=_REPO))
    return subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.launch", "--nproc", "2",
         "--device", "cpu", str(path)], capture_output=True, text=True,
        timeout=240, cwd=_REPO)


@pytest.mark.slow
def test_launch_two_processes(tmp_path):
    out = _launch(_SCRIPT, tmp_path, "worker.py")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LAUNCHED rank=0 ok" in out.stdout
    assert "LAUNCHED rank=1 ok" in out.stdout


_MESH_SHAPE_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.parallel import pipeline as pp

    mpi.init(mpi.Config(mesh_shape={{"pp": 2, "tp": -1}}), device="cpu")
    assert mpi.runtime.world_shape() == {{"pp": 2, "tp": 1}}
    S, M, mb, d = 2, 2, 2, 4
    rng = np.random.RandomState(0)
    W = rng.randn(S, d, d).astype(np.float32) * 0.3
    b = rng.randn(S, d).astype(np.float32) * 0.1
    xs = rng.randn(M, mb, d).astype(np.float32)
    me = mpi.runtime.axis_index("pp")

    def stage_fn(params, x):
        return torch.tanh(x @ params[0] + params[1])

    out = pp.gpipe_apply(stage_fn, (torch.from_numpy(W[me]),
                                    torch.from_numpy(b[me])),
                         torch.from_numpy(xs), "pp")
    expect = xs
    for s in range(S):
        expect = np.tanh(expect @ W[s] + b[s])
    np.testing.assert_allclose(out.detach().numpy(), expect, rtol=2e-5,
                               atol=2e-5)
    print(f"MESHSHAPE rank={{mpi.rank()}} ok", flush=True)
    mpi.stop()
""")


@pytest.mark.slow
def test_launch_mesh_shape_pipeline_across_processes(tmp_path):
    out = _launch(_MESH_SHAPE_SCRIPT, tmp_path, "worker_mesh.py")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "MESHSHAPE rank=0 ok" in out.stdout
    assert "MESHSHAPE rank=1 ok" in out.stdout


_ENV_SCRIPT = textwrap.dedent("""
    import json, os
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "TORCHMPI_TPU_DEVICE")
    print("ENV " + json.dumps({k: os.environ.get(k) for k in keys}),
          flush=True)
""")


@pytest.mark.parametrize("device", [None, "cuda", "cpu"])
def test_launch_layout_and_no_device_variable(tmp_path, device):
    """The launcher lays the processes out by ``--device`` (the card's
    layout by default: one node, a card a process) and passes no device
    to the script: only the script's own ``init(device=...)`` leaves the
    card."""
    path = tmp_path / "env.py"
    path.write_text(_ENV_SCRIPT)
    flags = [] if device is None else ["--device", device]
    env = {k: v for k, v in os.environ.items() if k != "TORCHMPI_TPU_DEVICE"}
    out = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.launch", "--nproc", "3",
         *flags, str(path)], capture_output=True, text=True, timeout=60,
        env=env, cwd=_REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    got = sorted((json.loads(ln[4:]) for ln in out.stdout.splitlines()
                  if ln.startswith("ENV ")), key=lambda d: int(d["RANK"]))
    per_node = 1 if device == "cpu" else 3
    assert [d["RANK"] for d in got] == ["0", "1", "2"]
    for r, d in enumerate(got):
        assert d["WORLD_SIZE"] == "3" and d["MASTER_ADDR"] == "127.0.0.1"
        assert d["LOCAL_RANK"] == str(r % per_node)
        assert d["LOCAL_WORLD_SIZE"] == str(per_node)
        assert d["TORCHMPI_TPU_DEVICE"] is None


def test_init_takes_no_device_from_the_environment(monkeypatch):
    """A bare ``init()`` means the card whatever the environment says:
    without one it raises rather than move to gloo on the CPU."""
    import torch

    import torchmpi_tpu_torch as mpi

    if torch.cuda.is_available():
        pytest.skip("a card is visible: init() would take it")
    mpi.stop()
    monkeypatch.setenv("TORCHMPI_TPU_DEVICE", "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mpi.init()
    assert not mpi.is_initialized()
