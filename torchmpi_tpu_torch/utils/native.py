"""Build and load the port's native host libraries (C ABI, ctypes).

Each ``torchmpi_tpu_torch/csrc/<name>.cpp`` (``ps``: the parameter-server
transport, ``io``: the asynchronous file writer) is compiled by the host
C++ compiler into its own shared library under ``build/torch_host/`` at the
repository root, with the flags of the JAX package's ``csrc/Makefile``
(``-O2 -std=c++17 -fPIC -Wall -Wextra -pthread``): no ``-march`` and no
``-ffast-math``, so the parameter server's update rules round the product
and the sum separately, as the JAX package's build does.  The library's
file name carries a digest of its source, the compiler and the flags, so
an edited source (or another compiler) builds anew and a built one is
reused.  The compiler
writes a file of its own and renames it into place, so processes that
build concurrently never open a half-written library.

Nothing is built at import: the first call that needs a library builds it.
A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_host"
LIBS = ("ps", "io")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``, else ``c++``."""
    for c in (os.environ.get("CXX"), "g++", "c++"):
        if c and shutil.which(c):
            return shutil.which(c)
    raise RuntimeError("no C++ compiler found (set CXX or put g++ on PATH); "
                       "the parameter server and the async writer build "
                       "from torchmpi_tpu_torch/csrc at first use")


def _compiler_id() -> str:
    """The compiler's path and the first line of its ``--version``."""
    cxx = compiler()
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    return f"{cxx} {(out.stdout or out.stderr).splitlines()[0:1]}"


def lib_path(name: str) -> Path:
    if name not in LIBS:
        raise ValueError(f"unknown host library {name!r} (known: {LIBS})")
    h = hashlib.sha256()
    h.update(" ".join((_compiler_id(),) + CXX_FLAGS).encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library ``name`` if it is missing; return its path."""
    path = lib_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}.", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [compiler(), *CXX_FLAGS, "-shared", "-o", tmp,
               str(CSRC / f"{name}.cpp")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"host library build failed ({' '.join(cmd)}"
                               f"):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load(name: str, bind: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed; ``bind(lib)``
    declares its ctypes signatures on the first load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            if bind is not None:
                bind(lib)
            _libs[name] = lib
        return lib
