"""Host-to-card input pipeline with background prefetch.

The counterpart of ``torchmpi_tpu/utils/input_pipeline.py``
(``prefetch_to_mesh`` :36).  While the card runs step N, a background
thread copies batch N+1 from pinned host memory to the card on a side
stream, so the host-to-device copy overlaps compute instead of
serializing with it.  The port has no mesh: each process feeds its own
card, so the function is ``prefetch_to_device``.

Usage::

    it = prefetch_to_device(batch_iter, depth=2)   # the runtime's card
    for xb, yb in it:          # already on the card
        state = step(state, xb, yb)

Works on a tuple, list or dict (nested) of numpy arrays or tensors per
batch.  ``depth`` bounds the staged batches (device memory = depth x batch
bytes).  The thread ends with the iterator (daemon, and released on early
close or when the iterator is dropped), and an exception in the source
iterator re-raises at the consumer.
"""

from __future__ import annotations

import queue
import threading
import weakref
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from .. import runtime

Batch = Any


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _host(leaf) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(leaf)) \
        if isinstance(leaf, np.ndarray) else torch.as_tensor(leaf)


def prefetch_to_device(batches: Iterable[Batch], *, depth: int = 2,
                       device=None) -> Iterator[Batch]:
    """Iterate copies of ``batches`` on ``device``: by default the
    runtime's device when it is initialized, else the card.

    On the card each batch is pinned, copied on a side stream, and handed
    over with an event that the consumer's current stream waits on (no
    host wait); its tensors are recorded on that stream so the allocator
    does not reuse them early.  ``device="cpu"`` (only when the caller asks
    for it) pins nothing and copies nothing that is already a CPU tensor."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    if device is None:
        device = runtime.device() if runtime.is_initialized() else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "prefetch_to_device(device='cuda'): no CUDA device is "
                "visible; pass device='cpu' to stay on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        side: Optional[torch.cuda.Stream] = torch.cuda.Stream(device=dev)
    elif dev.type == "cpu":
        side = None
    else:
        raise ValueError(f"unsupported device {device!r}")

    def put(batch: Batch):
        if side is None:
            return _tree_map(_host, batch), None
        with torch.cuda.device(dev), torch.cuda.stream(side):
            out = _tree_map(lambda a: _host(a).pin_memory().to(
                dev, non_blocking=True), batch)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    class _End:
        pass

    class _Error:
        def __init__(self, exc: BaseException):
            self.exc = exc

    def _enqueue(item) -> bool:
        # Bounded put that honours abandonment: an early-closed consumer
        # sets `stop` and the producer exits instead of blocking forever
        # holding device buffers.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in batches:
                if not _enqueue(put(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            _enqueue(_Error(e))
            return
        _enqueue(_End())

    # Plain function, not a generator: depth validation fails at the call
    # site and prefetching starts now, not at the first next().
    th = threading.Thread(target=producer, daemon=True,
                          name="torchmpi-prefetch")
    th.start()

    def _abandon():
        # Release the producer and drop staged batches.  Idempotent: runs
        # from the generator's finally and from its GC finalizer.
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass

    def consume() -> Iterator[Batch]:
        try:
            while True:
                item = q.get()
                if isinstance(item, _End):
                    return
                if isinstance(item, _Error):
                    raise item.exc
                out, ready = item
                if ready is not None:
                    stream = torch.cuda.current_stream(dev)
                    stream.wait_event(ready)
                    for t in _leaves(out):
                        t.record_stream(stream)
                yield out
        finally:
            # Early close (break / exception / GC of the iterator).
            _abandon()

    gen = consume()
    # A never-started generator skips its finally on GC (close() is a no-op
    # before the first next()), which would leave the producer spinning and
    # `depth` batches staged forever.  The finalizer covers that path; it
    # must not reference `gen` itself.
    weakref.finalize(gen, _abandon)
    return gen
