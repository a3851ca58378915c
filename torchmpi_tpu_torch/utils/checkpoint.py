"""Single-file checkpoints: save, save_async, restore.

The counterpart of the non-sharded part of ``torchmpi_tpu/utils/
checkpoint.py`` (``save`` :210, ``CheckpointHandle`` :260, ``save_async``
:315, ``latest_step`` / ``available_steps`` :403-407, ``restore`` :657),
with the same on-disk layout, so a checkpoint written by either package
restores in the other:

- every process writes ``ckpt_<step>_p<proc>.npz`` (``proc`` its rank in
  the port's runtime, 0 without one) and ``ckpt_<step>_p<proc>.json``, the
  record of each array's dtype;
- the npz keys are the ``"/"``-joined tree paths: dict keys, list and
  tuple indices, ``.<field>`` for a NamedTuple's fields (``jax.tree``'s
  path names); dict keys are taken in sorted order and None is no leaf;
- a bfloat16 leaf is written as numpy writes a JAX one: raw 2-byte voids
  (``|V2``) with ``"bfloat16"`` in the dtype record, and read back through
  its bits (a torch tensor through ``view(torch.int16)``), never through a
  float cast;
- each file is written to ``<path>.tmp.<pid>``, fsync'd and renamed into
  place, so a crash never leaves a torn file under the final name; stale
  staging files of dead writers are reaped.

Leaves are torch tensors (on any device), numpy arrays or scalars.
``restore`` returns each leaf as its template leaf is: a tensor on the
template's device, else a numpy array.  ``save_async`` takes the host
snapshot in the caller (the tensors go on training) and hands the
serialized bytes to the native writer (``aio.py``), whose one thread
commits the npz before its record, in order.

Not in this module: the durable-checkpoint mode (``Config.ckpt_*``,
``utils/durable.py``), the fault sites and fencing, and the sharded forms
(``save_sharded``, ``restore_sharded``, ``agree_min_step``,
``latest_sharded_step``, ``protect_step``, ``replicate_for``): the
recovery protocol of the resilience layer (ROADMAP queue A).
"""

from __future__ import annotations

import io as _io
import json
import os
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import _tree, runtime

PyTree = Any


class TemplateMismatchError(ValueError):
    """The restore template's shape or dtype contradicts the checkpoint:
    the model changed since the save."""


def _proc() -> int:
    return runtime.rank() if runtime.is_initialized() else 0


def _keyed_leaves(tree) -> List[Tuple[str, Any]]:
    """(path key, leaf) of every leaf in ``_tree.flatten``'s order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + [str(k)])
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for name, v in zip(node._fields, node):
                walk(v, prefix + [f".{name}"])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + [str(i)])
        else:
            out.append(("/".join(prefix), node))

    walk(tree, [])
    return out


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return np.asarray(leaf).dtype.name


def _snapshot(tree) -> Tuple[dict, dict]:
    """({path key: numpy array}, {path key: dtype name}) of ``tree``'s
    leaves (None skipped): the tensors on the card copied to pinned host
    memory on the current stream with one wait at the end, bfloat16 as its
    raw bits (``|V2``)."""
    pairs = [(k, x) for k, x in _keyed_leaves(tree) if x is not None]
    dtypes = {k: _dtype_name(x) for k, x in pairs}
    staged, on_card = [], False
    for key, x in pairs:
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                x, on_card = host, True
        staged.append((key, x))
    if on_card:
        torch.cuda.current_stream().synchronize()
    arrays = {}
    for key, x in staged:
        if isinstance(x, torch.Tensor):
            x = x.contiguous()
            arrays[key] = (x.view(torch.int16).numpy().view("V2")
                           if x.dtype == torch.bfloat16 else x.numpy())
        else:
            arrays[key] = np.asarray(x)
    return arrays, dtypes


def _meta(step: int, arrays: dict, dtypes: dict) -> dict:
    return {"step": step, "keys": sorted(arrays.keys()), "dtypes": dtypes}


_TMP_REAP_AGE_S = 600.0


def _reap_stale_tmp(directory: str) -> None:
    """Remove orphaned writer-unique staging files (``*.tmp.<pid>``) left
    by writers that died between staging and rename.  Age-gated: a live
    concurrent writer's staging file is seconds old."""
    try:
        names = os.listdir(directory)
    except OSError:
        return
    now = time.time()
    for n in names:
        stem, _, pid = n.rpartition(".tmp.")
        if not stem or not pid.isdigit():
            continue
        p = os.path.join(directory, n)
        try:
            if now - os.path.getmtime(p) > _TMP_REAP_AGE_S:
                os.remove(p)
        except OSError:
            pass


def _commit(path: str, write) -> None:
    """Commit a file to ``path``: ``write(f)`` into a writer-unique tmp
    file, flush, fsync and atomic rename."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _reap_stale_tmp(os.path.dirname(path))


def save(directory: str, tree: PyTree, *, step: int = 0) -> str:
    """Write a checkpoint; returns the npz path.  The npz streams straight
    to its staging file (no second in-memory copy), and both files are
    fsync'd before their renames."""
    os.makedirs(directory, exist_ok=True)
    proc = _proc()
    path = os.path.join(directory, f"ckpt_{step}_p{proc}.npz")
    arrays, dtypes = _snapshot(tree)
    _commit(path, lambda f: np.savez(f, **arrays))
    meta = json.dumps(_meta(step, arrays, dtypes)).encode()
    _commit(path[:-4] + ".json", lambda f: f.write(meta))
    return path


class CheckpointHandle:
    """Future for one async checkpoint (the data and metadata writes)."""

    def __init__(self, handles, path: str):
        self._handles = handles
        self.path = path

    def done(self) -> bool:
        return all(h.done() for h in self._handles)

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until the checkpoint is on disk; returns the npz path.
        ``timeout`` bounds the whole call (a deadline shared by the data
        and metadata writes).  Raises ``OSError`` if a write failed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for h in self._handles:
            h.wait(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        return self.path


_WRITER = None
_WRITER_LOCK = threading.Lock()


def _writer():
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None:
            import atexit

            from . import aio

            # One thread: FIFO order commits the npz before its metadata.
            _WRITER = aio.AsyncWriter(threads=1)
            # Drain and join at interpreter exit: exiting with the native
            # pool's threads joinable would terminate in the library's
            # static destructors.  close() is idempotent.
            atexit.register(_WRITER.close)
        return _WRITER


def save_async(directory: str, tree: PyTree, *, step: int = 0,
               durable: bool = True) -> CheckpointHandle:
    """Like :func:`save` but the disk IO runs on the native writer.

    Synchronous cost: the device-to-host copy of the tensors on the card
    (one wait, after the work queued before it on the current stream) and
    one in-memory npz serialization.  The write, fsync and atomic rename
    overlap training; ``handle.wait()`` (or a later ``save_async`` on the
    same FIFO writer) fences it.  The final file name only ever appears
    complete."""
    os.makedirs(directory, exist_ok=True)
    proc = _proc()
    path = os.path.join(directory, f"ckpt_{step}_p{proc}.npz")
    arrays, dtypes = _snapshot(tree)
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    w = _writer()
    h_data = w.submit(path, buf.getbuffer(), durable=durable)
    h_meta = w.submit(
        os.path.join(directory, f"ckpt_{step}_p{proc}.json"),
        json.dumps(_meta(step, arrays, dtypes)).encode(), durable=durable)
    return CheckpointHandle((h_data, h_meta), path)


def _steps(directory: str, prefix: str) -> list:
    suffix = f"_p{_proc()}.npz"
    found = set()
    if not os.path.isdir(directory):
        return []
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(suffix):
            try:
                found.add(int(name[len(prefix):-len(suffix)]))
            except ValueError:
                continue
    return sorted(found)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory, "ckpt_")
    return steps[-1] if steps else None


def available_steps(directory: str) -> list:
    """All restorable steps for this process, ascending."""
    return _steps(directory, "ckpt_")


def _undo_void(arr: np.ndarray, dtype: str, leaf) -> Any:
    """A stored array as ``leaf``'s kind: npz keeps bfloat16 as raw 2-byte
    voids, reinterpreted here through the bits (a tensor leaf through
    ``view(torch.bfloat16)``, a numpy leaf through its own dtype)."""
    bf16 = arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
        and dtype == "bfloat16"
    if isinstance(leaf, torch.Tensor):
        if bf16:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.asarray(arr))
        return t.to(leaf.device)
    if bf16:
        t_dtype = np.asarray(leaf).dtype
        return arr.view(t_dtype) if t_dtype.name == "bfloat16" \
            else arr.view(np.uint16)
    return arr


def _check_template(key: str, stored_shape, stored_dtype: str, leaf) -> None:
    """A template whose shape or dtype contradicts the checkpoint raises,
    instead of returning stale-shaped parameters that fail later."""
    t_shape = tuple(leaf.shape) if hasattr(leaf, "shape") \
        else tuple(np.shape(leaf))
    t_dtype = _dtype_name(leaf)
    if tuple(stored_shape) != t_shape or stored_dtype != t_dtype:
        raise TemplateMismatchError(
            f"{key!r}: checkpoint has {tuple(stored_shape)} {stored_dtype} "
            f"but template expects {t_shape} {t_dtype} — the model changed "
            f"since this checkpoint was saved")


def restore(directory: str, template: PyTree,
            *, step: Optional[int] = None) -> PyTree:
    """Restore into the structure of ``template`` (values replaced): the
    latest step unless ``step`` is given."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step}_p{_proc()}.npz")
    data = np.load(path)
    # The recorded dtypes are the authority for reinterpreting npz's
    # void-encoded bfloat16; a checkpoint without the record falls back
    # to the template's dtype.
    dtypes = {}
    meta_path = path[:-4] + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            dtypes = json.load(f).get("dtypes", {})
    pairs = _keyed_leaves(template)
    missing = [k for k, x in pairs if x is not None and k not in data]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    leaves = []
    for key, leaf in pairs:
        if leaf is None:
            leaves.append(None)
            continue
        arr = data[key]
        dtype = dtypes.get(key, _dtype_name(leaf))
        if not (arr.dtype.kind == "V" and dtype == "bfloat16"):
            dtype = arr.dtype.name
        _check_template(key, arr.shape, dtype, leaf)
        leaves.append(_undo_void(arr, dtype, leaf))
    return _tree.unflatten(_tree.flatten(template)[1], leaves)
