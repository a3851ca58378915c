"""The kernel build's ptxas log, kept beside each library.

``ops/_build.py`` compiles each CUDA source once into a library named by a
digest of its sources and keeps nvcc's output (the ptxas report that
``chip_smoke.py`` checks for spills) beside it.  A later process that
finds the library built reads that log instead of compiling again, and a
library whose log is missing is built again.  Here a stand-in ``nvcc``
(a shell script that writes the output file and prints a ptxas line)
counts the compiles; no CUDA toolkit is needed.
"""

import os
import stat

import pytest

from torchmpi_tpu_torch.ops import _build

REPORT = "ptxas info    : Used 40 registers, 0 bytes spill stores"


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc under $CUDA_HOME/bin that appends a line to
    ``calls`` per compile; the build directory under tmp_path."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    calls = tmp_path / "calls"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "out=''\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=\"$2\"; shift; fi\n"
        "  shift\n"
        "done\n"
        f"echo x >> '{calls}'\n"
        "printf 'lib' > \"$out\"\n"
        f"echo '{REPORT}'\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_logs", {})
    return lambda: len(calls.read_text().split()) if calls.exists() else 0


@pytest.mark.parametrize("names", [("flash_fwd",),
                                   ("flash_bwd_dq_wgmma",
                                    "flash_bwd_dkv_wgmma")])
def test_a_cached_library_brings_its_log(fake_nvcc, names):
    paths = _build.build(names)
    assert fake_nvcc() == len(names)
    for n in names:
        assert _build.build_logs[n].strip() == REPORT
        assert _build.log_path(paths[n]).read_text() == \
            _build.build_logs[n]
        assert paths[n].name.startswith(f"lib{n}-")
    # A later process: nothing compiled, the same logs.
    _build.build_logs.clear()
    assert _build.build(names) == paths
    assert fake_nvcc() == len(names)
    assert all(_build.build_logs[n].strip() == REPORT for n in names)


def test_a_library_without_its_log_builds_again(fake_nvcc):
    path = _build.build(["flash_fwd"])["flash_fwd"]
    os.unlink(_build.log_path(path))
    _build.build_logs.clear()
    _build.build(["flash_fwd"])
    assert fake_nvcc() == 2
    assert _build.build_logs["flash_fwd"].strip() == REPORT
    assert sorted(p.name for p in path.parent.iterdir()) == \
        sorted([path.name, _build.log_path(path).name])
