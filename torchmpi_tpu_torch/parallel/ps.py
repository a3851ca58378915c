"""Asynchronous parameter server: the Python client and servers over the
native host transport (``torchmpi_tpu_torch/csrc/ps.cpp``).

The port's counterpart of ``torchmpi_tpu/parallel/ps.py``, the reference's
parameter-server shards and client (``torchmpi.parameterserver``):

- a flat float32 parameter vector is sharded across server instances,
  each a set of native threads behind a loopback TCP listener, and
  clients reach them over TCP;
- clients ``send(tree, rule)`` / ``receive()`` asynchronously and wait on
  opaque handles (the prefetch pattern);
- server-side update rules: ``copy`` / ``add`` / ``zero`` / ``axpy`` and
  the EASGD ``elastic`` rule (the server replies with the elastic delta,
  so client and center move symmetrically).

The parameter server lives outside the collectives: its traffic is
asynchronous host traffic.  Trees of numpy arrays or CPU tensors take the
JAX package's numpy path.  Trees of tensors on the card are staged through
pinned host memory:

- a push (``send``) needs its host bytes complete at the native call,
  because ``tm_ps_send`` copies its payload before it returns: one
  non-blocking device-to-host copy into a pinned buffer on the calling
  thread's current stream, that copy's event waited on, then the native
  call.  That is the push's one host synchronization, inherent to the
  server; the pinned buffer is the calling thread's own (several worker
  threads share one client), allocated once and reused;
- a fetch (``receive``) and the elastic reply are written by the native
  thread after the call has returned, into a pinned buffer from the
  client's pool, which the handle keeps alive until ``wait()``; ``wait()``
  copies it to the card on the waiting thread's current stream without
  waiting for the copy, and the buffer goes back to the pool, to be
  reused once that copy's event has completed.

Dtype contract: the wire and shard format is float32; float32, bfloat16
and float16 leaves round-trip bit-exactly, anything lossy raises (see
``utils/tree.py``).  With ``Config.obs`` on, a handle's first completed
``wait()`` appends a ``ps_wait_done`` flight event (through the
``sys.modules``-gated ``utils.telemetry``) and every ``stats()`` snapshot
folds its deltas into the ``tm_ps_*_total`` counters.

With ``Config.faults`` armed (JAX :365-450), ``send`` / ``receive``
return a :class:`_ResilientPSHandle`: the exchange is enqueued under the
``ps.request`` site (an arrival an attempt, before the sockets are
touched) and its ``wait()`` runs the ``ps.response`` leg under the retry
policy, retransmitting the WHOLE exchange on a transient failure
(``faults.ps_wait``).  A push under the fault layer is staged once to a
host master (on the card: the push's one host sync) and each attempt's
payload is a fresh writable copy of it, so a corrupt flips that copy's
bits and a retry sends the clean master.  With ``Config.watchdog`` armed
a handle's native wait is a ``ps.response`` window.  Off, none of it
runs and neither module is imported.  With the wire guard armed
(``Config.guard`` "wire" | "full", JAX :68-72, :434-449) a push takes
the same resilient path whatever ``Config.faults`` says, and each
attempt's staged payload is digested at staging and verified at the
native handoff: a mismatch is a transient the policy retries by staging
the clean master again.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import runtime
from ..config import ps_timeout_s
from ..utils import native
from ..utils import tree as tree_util

PyTree = Any

RULES = {"copy": 0, "add": 1, "zero": 2, "axpy": 3, "elastic": 4}

_F32P = ctypes.POINTER(ctypes.c_float)


def _timeout_ms() -> int:
    """Socket timeout armed on every client connection: a wedged shard
    server surfaces as a failed future within this bound instead of
    hanging ``wait()``.  0 disables.  ``Config.ps_timeout_s`` once the
    runtime is up, else the environment (``config.ps_timeout_s``)."""
    value = runtime.config().ps_timeout_s if runtime.is_initialized() \
        else None
    return int(ps_timeout_s(value) * 1000)


# Last-resort keep-alive for buffers whose native op never completed within
# the destructor's bounded wait (should be unreachable with socket timeouts
# armed): leaking beats a native write into freed memory.
_ORPHANED_BUFFERS: List[Any] = []


def _bind(lib: ctypes.CDLL) -> None:
    lib.tm_ps_server_create.restype = ctypes.c_int64
    lib.tm_ps_server_create.argtypes = [ctypes.c_uint64, ctypes.c_int]
    lib.tm_ps_server_port.restype = ctypes.c_int
    lib.tm_ps_server_port.argtypes = [ctypes.c_int64]
    lib.tm_ps_server_ops.restype = ctypes.c_uint64
    lib.tm_ps_server_ops.argtypes = [ctypes.c_int64]
    lib.tm_ps_server_stats.restype = ctypes.c_int
    lib.tm_ps_server_stats.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
    lib.tm_ps_server_destroy.restype = None
    lib.tm_ps_server_destroy.argtypes = [ctypes.c_int64]
    lib.tm_ps_client_connect.restype = ctypes.c_int64
    lib.tm_ps_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int]
    lib.tm_ps_client_destroy.restype = None
    lib.tm_ps_client_destroy.argtypes = [ctypes.c_int64]
    lib.tm_ps_send.restype = ctypes.c_int64
    lib.tm_ps_send.argtypes = [
        ctypes.c_int64, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint64,
        _F32P, _F32P, ctypes.c_uint64]
    lib.tm_ps_receive.restype = ctypes.c_int64
    lib.tm_ps_receive.argtypes = [ctypes.c_int64, ctypes.c_uint64, _F32P,
                                  ctypes.c_uint64]
    lib.tm_ps_wait.restype = ctypes.c_int
    lib.tm_ps_wait.argtypes = [ctypes.c_int64]
    lib.tm_ps_wait_for.restype = ctypes.c_int
    lib.tm_ps_wait_for.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.tm_ps_test.restype = ctypes.c_int
    lib.tm_ps_test.argtypes = [ctypes.c_int64]
    lib.tm_ps_forget.restype = None
    lib.tm_ps_forget.argtypes = [ctypes.c_int64]
    lib.tm_ps_ping.restype = ctypes.c_int64
    lib.tm_ps_ping.argtypes = [ctypes.c_int64]


def _load_lib() -> ctypes.CDLL:
    """The host transport, built from the port's ``csrc/ps.cpp`` at first
    use (``utils/native.py``)."""
    return native.load("ps", _bind)


def _fptr(a, offset: int = 0):
    """A float pointer ``offset`` floats into ``a`` (a numpy array or a
    CPU tensor, pinned or not)."""
    if isinstance(a, torch.Tensor):
        return ctypes.cast(a.data_ptr() + 4 * offset, _F32P)
    return ctypes.cast(a.ctypes.data + 4 * offset, _F32P)


class PSHandle:
    """Opaque async handle (reference: ``parameterserver.syncHandle``'s
    target).

    Holds references to the buffers the native side writes into, so they
    stay alive until ``wait()``.  ``native_wait_s`` is the host time the
    handle's ``wait()`` spent on the native futures.
    """

    def __init__(self, lib, future_ids: List[int], buffers: List[Any],
                 result_fn=None):
        self._lib = lib
        self._pending = list(future_ids)  # not yet waited/freed
        self._n_futures = len(self._pending)
        self._buffers = buffers  # keep-alive
        self._result_fn = result_fn
        self._done = False
        self._failed = False
        self._result = None
        self.native_wait_s = 0.0
        # Shard index (enqueue order) of the first failed/timed-out
        # future.  None = no failure seen.
        self.failed_index: Optional[int] = None

    def wait(self, timeout_ms: int = 0):
        """Block until every shard future resolves.  ``timeout_ms > 0``
        bounds each per-shard native wait; on expiry raises
        ``TimeoutError`` with the future left live (the handle can be
        waited again, or abandoned to the bounded destructor drain)."""
        if self._failed:
            raise RuntimeError("parameter-server op already failed")
        if not self._done:
            wd = None
            wd_tok = -1
            if runtime.effective_config().watchdog != "off":
                # The native shard waits as an in-flight window (JAX
                # :168-182): under timeout_ms=0 the watchdog is the only
                # bound on a wedged shard.
                from .. import watchdog as wd

                wd.raise_pending()
                wd_tok = wd.begin("ps.response", op="ps_wait",
                                  nbytes=self._n_futures)
            t0 = time.perf_counter()
            try:
                self._wait_native(timeout_ms)
            finally:
                self.native_wait_s += time.perf_counter() - t0
                if wd is not None:
                    wd.end(wd_tok)
            self._done = True
            self._result = (self._result_fn() if self._result_fn is not None
                            else None)
            self._buffers = []
            from ..utils import telemetry

            # The completion edge of a PS wait, once a handle (JAX
            # :188-193): blame can see the exchange completed.
            telemetry.emit("record_ps_wait", self._n_futures)
        return self._result

    def _wait_native(self, timeout_ms: int = 0) -> None:
        while self._pending:
            fid = self._pending[0]
            if timeout_ms and timeout_ms > 0:
                status = self._lib.tm_ps_wait_for(fid, int(timeout_ms))
                if status == -3:  # still in flight; future stays live
                    self.failed_index = self._n_futures - len(self._pending)
                    raise TimeoutError(
                        f"parameter-server op still in flight after "
                        f"{timeout_ms}ms (shard {self.failed_index})")
            else:
                status = self._lib.tm_ps_wait(fid)  # frees the future
            self._pending.pop(0)
            if status != 1:
                self.failed_index = self._n_futures - len(self._pending) - 1
                self._failed = True
                self._drain_pending()
                raise RuntimeError(f"parameter-server op failed (status "
                                   f"{status}, shard {self.failed_index})")

    def _drain_pending(self):
        """Retire remaining futures after a failure.  Futures whose native
        ops write into our buffers (other shards of a receive may still be
        in flight: shard failures are per connection) are drained with a
        bounded wait; if one is still in flight after the budget, its
        buffers are parked in _ORPHANED_BUFFERS rather than freed under a
        writing native thread."""
        t_ms = _timeout_ms()
        budget_ms = 2 * t_ms if t_ms > 0 else 0
        for rest in self._pending:
            if self._result_fn is None:
                self._lib.tm_ps_forget(rest)
            elif budget_ms > 0:
                if self._lib.tm_ps_wait_for(rest, budget_ms) == -3:
                    _ORPHANED_BUFFERS.append(self._buffers)
                    self._lib.tm_ps_forget(rest)
            else:
                self._lib.tm_ps_wait(rest)
        self._pending = []

    @property
    def done(self) -> bool:
        if self._done or self._failed:
            return True
        return all(self._lib.tm_ps_test(fid) == 1 for fid in self._pending)

    def __del__(self):
        # Fire-and-forget handles (pushes never waited on) must not leak
        # future registry entries in the native layer.  Handles whose ops
        # write back into our buffers (receive / elastic, marked by
        # result_fn) are drained instead: forgetting them would free
        # memory the native thread still writes.  The drain is bounded
        # (2x the socket timeout) so garbage collection never hangs on a
        # wedged server.
        try:
            if getattr(self, "_pending", None):
                self._drain_pending()
        except Exception:
            pass


class ShardedParameterServer:
    """Server side: ``num_shards`` shard servers as native threads, the
    flat vector cut into equal contiguous ranges; every worker connects
    with :class:`PSClient`."""

    def __init__(self, total_floats: int, num_shards: int = 1,
                 base_port: int = 0):
        self._lib = _load_lib()
        self.total = int(total_floats)
        self.num_shards = num_shards
        bounds = np.linspace(0, self.total, num_shards + 1).astype(np.int64)
        self.shard_bounds: List[Tuple[int, int]] = [
            (int(bounds[i]), int(bounds[i + 1])) for i in range(num_shards)]
        self.server_ids: List[int] = []
        self.ports: List[int] = []
        self._last_stats: Optional[dict] = None
        for i, (lo, hi) in enumerate(self.shard_bounds):
            port = 0 if base_port == 0 else base_port + i
            sid = self._lib.tm_ps_server_create(hi - lo, port)
            if sid < 0:
                raise RuntimeError("failed to start PS shard server")
            self.server_ids.append(sid)
            self.ports.append(self._lib.tm_ps_server_port(sid))

    def ops_served(self) -> int:
        return sum(self._lib.tm_ps_server_ops(s) for s in self.server_ids)

    def _read_counters(self) -> np.ndarray:
        tot = np.zeros(8, dtype=np.uint64)
        buf = (ctypes.c_uint64 * 8)()
        for sid in self.server_ids:
            if self._lib.tm_ps_server_stats(sid, buf, 8) >= 7:
                tot += np.ctypeslib.as_array(buf)
        return tot

    def stats(self) -> dict:
        """Where the server loop's time went, summed over shards, in
        seconds: ``recv_s`` (payload reads), ``lock_wait_s`` (shard-mutex
        contention), ``apply_s`` (the rule loop or memcpy under the
        mutex), ``send_s`` (response writes); and ``ops``, ``bytes_in``,
        ``bytes_out`` and ``elastic_bytes_out`` (the elastic replies
        inside ``bytes_out``).  The idle wait between requests is in no
        bucket.  Every op a completed ``wait()`` observed is counted in
        ``ops`` / ``bytes_in`` / ``recv_s`` / ``lock_wait_s`` /
        ``apply_s``; ``send_s`` / ``bytes_out`` / ``elastic_bytes_out``
        land after the response write and may lag by the ops in flight.
        With ``Config.obs`` on, each snapshot's deltas against the previous
        one are folded into the registry as ``tm_ps_<key>_total`` counters
        (JAX :333-349)."""
        tot = self._read_counters()
        out = {
            "ops": int(tot[0]),
            "bytes_in": int(tot[1]),
            "bytes_out": int(tot[2]),
            "recv_s": float(tot[3]) / 1e9,
            "lock_wait_s": float(tot[4]) / 1e9,
            "apply_s": float(tot[5]) / 1e9,
            "send_s": float(tot[6]) / 1e9,
            "elastic_bytes_out": int(tot[7]),
        }
        if runtime.effective_config().obs != "off":
            from .. import obs

            obs.record_ps_stats(out, self._last_stats)
            self._last_stats = dict(out)
        return out

    def shutdown(self) -> None:
        for sid in self.server_ids:
            self._lib.tm_ps_server_destroy(sid)
        self.server_ids = []

    def __del__(self):  # best effort
        try:
            self.shutdown()
        except Exception:
            pass


class _PinnedPool:
    """Pinned float32 host buffers for the native side to write into
    (fetches, elastic replies).  A buffer goes back with the event of the
    copy out of it and is handed out again only once that event has
    completed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: List[list] = []  # [buffer, event or None]

    def acquire(self, n: int) -> torch.Tensor:
        with self._lock:
            for i, (buf, ev) in enumerate(self._free):
                if buf.numel() >= n and (ev is None or ev.query()):
                    del self._free[i]
                    return buf
        return torch.empty(n, dtype=torch.float32, pin_memory=True)

    def release(self, buf: torch.Tensor, event) -> None:
        with self._lock:
            self._free.append([buf, event])


def _faults_armed() -> bool:
    return runtime.effective_config().faults != "off"


def _wire_guard() -> bool:
    """One string compare a call: the wire guard (``faults/integrity.py``
    is never imported unless it is armed)."""
    return runtime.effective_config().guard in ("wire", "full")


class _ResilientPSHandle:
    """The handle ``send`` / ``receive`` return with ``Config.faults``
    armed (JAX :365-395): the exchange is already enqueued (the async
    overlap is kept); ``wait()`` runs under the retry policy,
    retransmitting the whole exchange on a transient failure and
    recording per-shard peer health (``faults.ps_wait``).  ``done``
    reflects the attempt enqueued now."""

    def __init__(self, inner: PSHandle, make_handle, peers: List[str]):
        self._inner = inner
        self._make = make_handle
        self._peers = peers
        self._result = None
        self._waited = False

    def wait(self):
        if not self._waited:
            from .. import faults

            self._result = faults.ps_wait(self._peers, self._make,
                                          self._inner)
            self._waited = True
        return self._result

    @property
    def done(self) -> bool:
        return self._waited or self._inner.done


class PSClient:
    """Client side: async send / receive against the shard servers.

    ``staging()`` reports the card path's staging counters: pushes, the
    push split into the wait for its device-to-host copy (its one host
    sync) and the native enqueue, fetches and their split into the native
    wait and the host-to-device copy (device time).
    """

    def __init__(self, template: PyTree, ports: Sequence[int],
                 shard_bounds: Sequence[Tuple[int, int]],
                 host: str = "127.0.0.1"):
        self._lib = _load_lib()
        _, self.spec = tree_util.flatten_f32(template)
        self.total = self.spec.total
        self.shard_bounds = list(shard_bounds)
        self.client_ids: List[int] = []
        self._tls = threading.local()
        self._pool = _PinnedPool()
        self._stats_lock = threading.Lock()
        self._counts = {"pushes": 0, "push_d2h_wait_s": 0.0,
                        "push_enqueue_s": 0.0, "fetches": 0,
                        "fetch_wait_s": 0.0, "fetch_h2d_ms": 0.0}
        self._h2d_events: List[tuple] = []
        # The fault layer's peer names: one a shard endpoint.
        self.peers: List[str] = [f"{host}:{int(p)}" for p in ports]
        for port in ports:
            cid = self._lib.tm_ps_client_connect(host.encode(), int(port),
                                                 _timeout_ms())
            if cid < 0:
                raise RuntimeError(f"failed to connect to PS at "
                                   f"{host}:{port}")
            self.client_ids.append(cid)

    def _check_live(self) -> None:
        if not self.client_ids:
            raise RuntimeError("PS client is shut down")

    def _add(self, **kw) -> None:
        with self._stats_lock:
            for k, v in kw.items():
                self._counts[k] += v

    def staging(self) -> dict:
        """The staging counters so far (see the class docstring); reading
        ``fetch_h2d_ms`` waits for the recorded copies' events."""
        with self._stats_lock:
            for _, end in self._h2d_events:
                end.synchronize()
            self._fold_h2d()
            return dict(self._counts)

    def _fold_h2d(self) -> None:
        """Add the completed host-to-device copies' device time to the
        counters (under the stats lock)."""
        left = []
        for start, end in self._h2d_events:
            if end.query():
                self._counts["fetch_h2d_ms"] += start.elapsed_time(end)
            else:
                left.append((start, end))
        self._h2d_events = left

    def reset_staging(self) -> None:
        with self._stats_lock:
            for k in self._counts:
                self._counts[k] = type(self._counts[k])(0)
            self._h2d_events = []

    def send(self, tree: PyTree, rule: str = "add",
             alpha: float = 1.0) -> PSHandle:
        """Async push (reference: ``ps.send(handle, grads, rule)``).

        For ``rule="elastic"`` the handle's ``wait()`` returns the elastic
        delta tree (subtract it from the local parameters: EASGD), on the
        sent tree's device."""
        self._check_live()
        rid = RULES[rule]
        flat, spec = tree_util.flatten_f32(tree)
        if flat.shape[0] != self.total:
            raise ValueError(f"tree has {flat.shape[0]} floats, PS holds "
                             f"{self.total}")
        wire = _wire_guard()
        if _faults_armed() or wire:
            return self._send_resilient(flat, spec, rid, float(alpha),
                                        wire)
        if isinstance(flat, torch.Tensor) and flat.is_cuda:
            return self._send_cuda(flat, spec, rid, float(alpha))
        if isinstance(flat, torch.Tensor):
            flat = flat.numpy()
        return self._send_host(flat, spec, rid, float(alpha))

    def _send_resilient(self, flat, spec, rid: int, alpha: float,
                        wire: bool = False) -> "_ResilientPSHandle":
        """A push under the fault layer (sites ``ps.request`` /
        ``ps.response``): the flat vector staged once to a host master,
        each attempt's payload a fresh copy of it (digest-checked with
        ``wire``)."""
        from .. import faults

        cuda = isinstance(flat, torch.Tensor) and flat.is_cuda
        if cuda:
            t0 = time.perf_counter()
            master = torch.empty(self.total, dtype=torch.float32,
                                 pin_memory=True)
            master.copy_(flat, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            event.synchronize()  # the push's one host sync
            self._add(pushes=1, push_d2h_wait_s=time.perf_counter() - t0)
        else:
            master = flat.numpy() if isinstance(flat, torch.Tensor) else flat

        def stage():
            return master.clone() if cuda else master.copy()

        def enqueue(payload) -> PSHandle:
            elastic = rid == RULES["elastic"]
            inout = None
            if elastic:
                inout = (self._pool.acquire(self.total) if cuda
                         else np.zeros_like(payload))
            fids = self._enqueue(payload, inout, rid, alpha)
            if not elastic:
                return PSHandle(self._lib, fids, [payload])
            fin = ((lambda: self._to_device(inout, spec, flat.device))
                   if cuda else
                   (lambda: tree_util.unflatten_f32(spec, inout)))
            return PSHandle(self._lib, fids, [payload, inout], fin)

        return _ResilientPSHandle(
            faults.ps_enqueue(self.peers, enqueue, stage=stage,
                              wire_guard=wire),
            lambda: faults.ps_exchange_once(self.peers, stage, enqueue,
                                            wire_guard=wire),
            self.peers)

    def _enqueue(self, flat, inout, rid: int, alpha: float) -> List[int]:
        """One ``tm_ps_send`` a shard from ``flat`` (host memory), the
        elastic reply into ``inout``; the shards' future ids."""
        fids = []
        for cid, (lo, hi) in zip(self.client_ids, self.shard_bounds):
            fid = self._lib.tm_ps_send(
                cid, rid, alpha, 0, _fptr(flat, lo),
                None if inout is None else _fptr(inout, lo), hi - lo)
            if fid < 0:
                raise RuntimeError("ps send failed to enqueue")
            fids.append(fid)
        return fids

    def _send_host(self, flat: np.ndarray, spec, rid: int,
                   alpha: float) -> PSHandle:
        inout = np.zeros_like(flat) if rid == RULES["elastic"] else None
        fids = self._enqueue(flat, inout, rid, alpha)
        if inout is None:
            return PSHandle(self._lib, fids, [flat])
        return PSHandle(self._lib, fids, [flat, inout],
                        lambda: tree_util.unflatten_f32(spec, inout))

    def _send_buffer(self, n: int):
        """This thread's pinned push buffer (at least ``n`` floats) and
        its copy event."""
        tls = self._tls
        buf = getattr(tls, "buf", None)
        if buf is None or buf.numel() < n:
            tls.buf = buf = torch.empty(n, dtype=torch.float32,
                                        pin_memory=True)
            tls.event = torch.cuda.Event()
        return buf, tls.event

    def _send_cuda(self, flat: torch.Tensor, spec, rid: int,
                   alpha: float) -> PSHandle:
        n = self.total
        t0 = time.perf_counter()
        buf, event = self._send_buffer(n)
        buf[:n].copy_(flat, non_blocking=True)
        event.record()
        event.synchronize()  # the push's one host sync
        t1 = time.perf_counter()
        inout = (self._pool.acquire(n) if rid == RULES["elastic"] else None)
        fids = self._enqueue(buf, inout, rid, alpha)
        self._add(pushes=1, push_d2h_wait_s=t1 - t0,
                  push_enqueue_s=time.perf_counter() - t1)
        # The payload was copied by tm_ps_send: this thread's buffer is
        # free again, and only the elastic reply needs keeping alive.
        if inout is None:
            return PSHandle(self._lib, fids, [])
        return PSHandle(self._lib, fids, [inout],
                        lambda: self._to_device(inout, spec, flat.device))

    def _to_device(self, host: torch.Tensor, spec, device) -> PyTree:
        """Copy the pinned ``host`` buffer to ``device`` on the current
        stream (no wait), return it to the pool with the copy's event, and
        unflatten it."""
        n = self.total
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = torch.empty(n, dtype=torch.float32, device=device)
        start.record()
        out.copy_(host[:n], non_blocking=True)
        end.record()
        self._pool.release(host, end)
        with self._stats_lock:
            self._h2d_events.append((start, end))
            if len(self._h2d_events) > 64:
                self._fold_h2d()
        return tree_util.unflatten_f32(spec, out)

    def receive(self) -> PSHandle:
        """Async pull of the full parameter vector (prefetch pattern);
        ``wait()`` returns the tree, on the template's device."""
        self._check_live()
        if _faults_armed() or _wire_guard():
            from .. import faults

            return _ResilientPSHandle(
                faults.ps_enqueue(self.peers, self._receive_once),
                lambda: faults.ps_exchange_once(self.peers, None,
                                                self._receive_once),
                self.peers)
        return self._receive_once()

    def _receive_once(self) -> PSHandle:
        if self.spec.device is not None and self.spec.device.type == "cuda":
            out = self._pool.acquire(self.total)
        else:
            out = np.zeros((self.total,), np.float32)
        fids = []
        for cid, (lo, hi) in zip(self.client_ids, self.shard_bounds):
            fid = self._lib.tm_ps_receive(cid, 0, _fptr(out, lo), hi - lo)
            if fid < 0:
                raise RuntimeError("ps receive failed to enqueue")
            fids.append(fid)
        if isinstance(out, np.ndarray):
            return PSHandle(self._lib, fids, [out],
                            lambda: tree_util.unflatten_f32(self.spec, out))
        h = PSHandle(self._lib, fids, [out])

        def finish():
            self._add(fetches=1, fetch_wait_s=h.native_wait_s)
            return self._to_device(out, self.spec, self.spec.device)

        h._result_fn = finish
        return h

    def ping(self) -> List[bool]:
        """Liveness of each shard server: a ping round-trips on every
        connection; False = shard unreachable."""
        self._check_live()
        handles = [PSHandle(self._lib, [self._lib.tm_ps_ping(cid)], [])
                   for cid in self.client_ids]
        alive = []
        for h in handles:
            try:
                h.wait()
                alive.append(True)
            except RuntimeError:
                alive.append(False)
        if _faults_armed():
            from .. import faults

            # Liveness probes feed the ledger the resilient exchanges
            # read: a healed shard is re-admitted by one good ping.
            for peer, ok in zip(self.peers, alive):
                faults.ledger().record(peer, ok)
        return alive

    def shutdown(self) -> None:
        for cid in self.client_ids:
            self._lib.tm_ps_client_destroy(cid)
        self.client_ids = []

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


class ParameterServer:
    """Single-process convenience: servers + one client, the shape the
    reference exposed via ``parameterserver.init(flatParams)``."""

    def __init__(self, template: PyTree, num_shards: int = 2,
                 host: str = "127.0.0.1", base_port: int = 0,
                 init: str = "copy"):
        _, spec = tree_util.flatten_f32(template)
        self.servers = ShardedParameterServer(spec.total, num_shards,
                                              base_port)
        self.client = PSClient(template, self.servers.ports,
                               self.servers.shard_bounds, host)
        if init == "copy":
            self.client.send(template, rule="copy").wait()

    def send(self, tree: PyTree, rule: str = "add",
             alpha: float = 1.0) -> PSHandle:
        return self.client.send(tree, rule, alpha)

    def receive(self) -> PSHandle:
        return self.client.receive()

    def ops_served(self) -> int:
        return self.servers.ops_served()

    def stats(self) -> dict:
        """Server-loop cycle-cost decomposition: see
        :meth:`ShardedParameterServer.stats`."""
        return self.servers.stats()

    def healthy(self) -> bool:
        """All shard servers reachable (see :meth:`PSClient.ping`)."""
        return all(self.client.ping())

    def shutdown(self) -> None:
        self.client.shutdown()
        self.servers.shutdown()


def sync_handle(h: PSHandle):
    """Reference: ``parameterserver.syncHandle(h)``."""
    return h.wait()
