"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface under
``build/torch_kernels/`` at the repository root, and loaded with ``ctypes``.
The library's file name carries a digest of its sources and flags, so an
edited source builds anew and a built one is reused.  Several kernels build
in parallel: one ``nvcc`` process per source, all started together.

Nothing is compiled at import: the first call that launches a kernel builds
it (or ``build()`` builds them all up front).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "xent_fwd", "xent_bwd_dx", "xent_bwd_dw", "ring_direct")
# Kernels whose launcher lives in another kernel's library (a second C
# launcher of the same source): kernel name -> library name.
SHARED_LIBRARY = {"flash_fwd_residual": "flash_fwd"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output (ptxas register / shared-memory / spill report) of
# the build this process ran, for callers that print it.
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every kernel in ``names`` whose library is missing, all in
    parallel, and return each kernel's library path.  Raises with nvcc's
    output if a build fails."""
    names = list(names)
    for n in names:
        if n not in KERNELS:
            raise ValueError(f"unknown kernel {n!r} (known: {KERNELS})")
    paths = {n: lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    try:
        for n, p in todo.items():
            tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, p)
        failed = []
        for n, (proc, tmp, p) in procs.items():
            out, _ = proc.communicate()
            build_logs[n] = out
            if proc.returncode != 0:
                failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n"
                              f"{out}")
            else:
                os.replace(tmp, p)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (of its library, for a kernel
    of ``SHARED_LIBRARY``), built first if needed."""
    name = SHARED_LIBRARY.get(name, name)
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib


def launch(name: str, symbol: str, argtypes, *args) -> None:
    """Call the C launcher ``symbol`` of kernel ``name`` (argument types
    ``argtypes``; it returns a CUDA error code) with ``args``; raise with
    the error's text if the launch was refused."""
    lib = load(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        lib.tm_error_string.argtypes = [ctypes.c_int]
        lib.tm_error_string.restype = ctypes.c_char_p
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: "
                           f"{lib.tm_error_string(rc).decode()} ({rc})")
