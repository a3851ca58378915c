"""Asynchronous host-IO executor: the Python wrapper over the port's
``csrc/io.cpp``.

The counterpart of ``torchmpi_tpu/utils/aio.py`` (``WriteHandle`` :60,
``AsyncWriter`` :117): a native thread pool with futures, whose job is
host IO that must overlap the train loop, checkpoint writes first of all
(``checkpoint.save_async``).

Buffer-lifetime contract: the native layer does not copy submitted data
(saving a second copy of a multi-GB checkpoint is the point), so every
``WriteHandle`` keeps its buffer until the future completes; an unwaited
handle that is garbage-collected never blocks: if its write is still in
flight, the buffer is parked in a module-level keep-alive list instead (a
leak beats a native write into freed memory).  With ``Config.faults``
armed, ``submit`` is the fault layer's ``aio.submit`` site (JAX :146):
injected delays and drops, the enqueue retried; off, one string compare
and the layer never imported.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Any, List, Optional

from . import native

_ORPHANED_BUFFERS: List[Any] = []


def _bind(lib: ctypes.CDLL) -> None:
    lib.tm_io_executor_create.restype = ctypes.c_int64
    lib.tm_io_executor_create.argtypes = [ctypes.c_int]
    lib.tm_io_submit_write.restype = ctypes.c_int64
    lib.tm_io_submit_write.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_uint64, ctypes.c_int]
    lib.tm_io_wait_for.restype = ctypes.c_int
    lib.tm_io_wait_for.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.tm_io_status.restype = ctypes.c_int
    lib.tm_io_status.argtypes = [ctypes.c_int64]
    lib.tm_io_free.restype = None
    lib.tm_io_free.argtypes = [ctypes.c_int64]
    lib.tm_io_bytes_written.restype = ctypes.c_uint64
    lib.tm_io_bytes_written.argtypes = [ctypes.c_int64]
    lib.tm_io_executor_destroy.restype = None
    lib.tm_io_executor_destroy.argtypes = [ctypes.c_int64]


def _load_lib() -> ctypes.CDLL:
    """The executor, built from the port's ``csrc/io.cpp`` at first use
    (``utils/native.py``)."""
    return native.load("io", _bind)


class WriteHandle:
    """Future for one atomic file write (keeps the source buffer)."""

    def __init__(self, lib: ctypes.CDLL, fid: int, path: str, buffer: Any):
        self._lib = lib
        self._fid = fid
        self.path = path
        self._buffer = buffer  # keep-alive until the native op completes
        self._err: Optional[int] = None  # sticky once the future resolves

    def done(self) -> bool:
        if self._fid is None:
            return True
        return self._lib.tm_io_status(self._fid) != -2

    def _raise_if_failed(self) -> None:
        if self._err:
            raise OSError(
                self._err,
                f"{os.strerror(self._err) if self._err > 0 else 'lost'}"
                f": {self.path}")

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until the write lands; returns the final path.  Raises
        ``TimeoutError`` (future stays live) or ``OSError`` with the native
        errno on failure.  Failure is sticky: every later ``wait``
        re-raises, so a retried wait never reports a write that did not
        happen."""
        if self._fid is None:
            self._raise_if_failed()
            return self.path
        ms = -1 if timeout is None else max(0, int(timeout * 1000))
        rc = self._lib.tm_io_wait_for(self._fid, ms)
        if rc == 0:
            raise TimeoutError(f"write of {self.path} still in flight "
                               f"after {timeout}s")
        self._err = self._lib.tm_io_status(self._fid) if rc == 1 else -1
        self._lib.tm_io_free(self._fid)
        self._fid = None
        self._buffer = None
        self._raise_if_failed()
        return self.path

    def __del__(self):
        # Never block garbage collection on the disk: if the future is
        # still in flight, park the buffer and release at once.  A
        # non-blocking poll settles the common case of a finished write.
        if getattr(self, "_fid", None) is None:
            return
        try:
            self.wait(timeout=0.0)
        except TimeoutError:
            _ORPHANED_BUFFERS.append((self._fid, self._buffer))
        except Exception:
            pass  # a failed write has nowhere to raise from a finalizer


class AsyncWriter:
    """Thread-pool file writer with atomic tmp + rename semantics.

    ``threads=1`` (the default) completes writes in submission order:
    submitting the data file before its metadata file orders them on
    disk, which is how ``checkpoint.save_async`` commits.
    """

    def __init__(self, threads: int = 1):
        self._lib = _load_lib()
        self._eid = self._lib.tm_io_executor_create(threads)
        if self._eid < 0:
            raise RuntimeError(f"bad executor thread count {threads}")
        self._lock = threading.Lock()

    def submit(self, path: str, data, *, durable: bool = True) -> WriteHandle:
        """Queue an atomic write of ``data`` (bytes-like) to ``path``,
        fsync'd when ``durable``.  Zero-copy: the buffer is kept on the
        returned handle, not copied (embedded NULs are fine: the native
        side writes ``len`` bytes).  With ``Config.faults`` armed the
        submission runs under the fault layer (site ``aio.submit``)."""
        from .. import runtime

        if runtime.effective_config().faults != "off":
            from .. import faults

            return faults.aio_submit(
                lambda: self._submit_once(path, data, durable))
        return self._submit_once(path, data, durable)

    def _submit_once(self, path: str, data, durable: bool) -> WriteHandle:
        if isinstance(data, bytes):
            n, ptr, pin = len(data), data, (data,)
        else:
            mv = memoryview(data).cast("B")
            n = len(mv)
            if mv.readonly:  # rare: copy once rather than reject
                b = bytes(mv)
                ptr, pin = b, (b,)
            else:
                ptr = (ctypes.c_char * n).from_buffer(mv) if n else None
                pin = (mv, ptr, data)
        with self._lock:
            if self._eid is None:
                raise RuntimeError("writer is closed")
            fid = self._lib.tm_io_submit_write(
                self._eid, path.encode(), ptr, n, 1 if durable else 0)
        if fid < 0:
            raise RuntimeError(f"submit failed for {path}")
        return WriteHandle(self._lib, fid, path, pin)

    def bytes_written(self) -> int:
        with self._lock:
            if self._eid is None:
                return 0
            return self._lib.tm_io_bytes_written(self._eid)

    def close(self) -> None:
        """Drain queued writes and join the pool."""
        with self._lock:
            eid, self._eid = self._eid, None
        if eid is not None:
            self._lib.tm_io_executor_destroy(eid)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
