"""Checkpoints: single-file and sharded saves, restores, and the recovery
evidence the restart loop stands on.

The counterpart of ``torchmpi_tpu/utils/checkpoint.py``, with the same
on-disk layout, so a checkpoint written by either package restores in the
other:

- every process writes ``ckpt_<step>_p<proc>.npz`` (``proc`` its rank in
  the port's runtime, 0 without one) and ``ckpt_<step>_p<proc>.json``, the
  record of each array's dtype (and, with ``Config.ckpt_redundancy`` on,
  the blake2b digest of the npz bytes);
- the npz keys are the ``"/"``-joined tree paths: dict keys, list and
  tuple indices, ``.<field>`` for a NamedTuple's fields (``jax.tree``'s
  path names); dict keys are taken in sorted order and None is no leaf;
- a bfloat16 leaf is written as numpy writes a JAX one: raw 2-byte voids
  (``|V2``) with ``"bfloat16"`` in the dtype record, and read back through
  its bits (a torch tensor through ``view(torch.int16)``), never through a
  float cast;
- each file is written to ``<path>.tmp.<pid>``, fsync'd and renamed into
  place, so a crash never leaves a torn file under the final name; stale
  staging files of dead writers are reaped, and ``.tmp`` artifacts are
  invisible to the step listings;
- a sharded checkpoint is ``shckpt_<step>_p<proc>.npz`` / ``.json``: each
  process writes the shards it holds, npz names ``<key>//<i>``, the record
  ``{"step", "leaves": {key: {"shape", "dtype", "shards": [{"extents",
  "name"}]}}}`` with a leaf's global shape and each shard's
  ``[[start, stop], ...]``; a replicated copy of a shard (the same
  extents) is written once.

Leaves are torch tensors (on any device), numpy arrays or scalars, and,
for the sharded forms, :class:`Sharded` descriptors (the port has no
sharded array type: the descriptor names a leaf's global shape and dtype
and the extents of the shards this process holds).  ``restore`` returns
each leaf as its template leaf is: a tensor on the template's device, else
a numpy array.  ``save_async`` takes the host snapshot in the caller (the
tensors go on training) and hands the serialized bytes to the native
writer (``aio.py``), whose one thread commits the npz before its record.

The durable mode (``Config.ckpt_redundancy`` "verify" / "buddy",
``utils/durable.py``) is one string compare at each entry: off, that
module is never imported.  The ``ckpt.write`` / ``ckpt.read`` fault sites
(``faults.ckpt_write`` / ``ckpt_read``) and the writer fence
(``faults/fencing.py``) are reached through ``sys.modules`` only.
"""

from __future__ import annotations

import io as _io
import json
import os
import sys
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _tree, runtime

PyTree = Any
_PKG = __name__.rsplit(".", 2)[0]


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed its integrity check: the digest recorded
    at save time does not match the bytes read back and (in buddy mode) no
    buddy copy verified either.  Typed so ``restart.recover``'s walk-back
    records it as ``corrupt`` evidence and tries the next older step."""

    def __init__(self, path: str, *, step: Optional[int] = None,
                 expect: str = "", got: str = "",
                 reason: str = "digest mismatch"):
        self.path = path
        self.step = step
        self.expect = expect
        self.got = got
        self.reason = reason
        detail = (f" (digest {got[:12]} != recorded {expect[:12]})"
                  if expect and got else "")
        super().__init__(f"{path}: checkpoint corrupt — {reason}{detail}")


class TemplateMismatchError(ValueError):
    """The restore template's shape or dtype contradicts the checkpoint:
    the model changed since the save."""


class Sharded:
    """A sharded leaf: its global ``shape`` and ``dtype`` and, for each
    shard this process holds, its ``extents`` (``[start, stop)`` a dim of
    the global array) and, unless the descriptor is a template, its tensor
    in ``shards``.  The port's counterpart of a sharded ``jax.Array`` (and,
    without data, of ``jax.ShapeDtypeStruct(sharding=)``): a layout written
    down, not inferred from a mesh.  Build it with :meth:`rank_major` or
    :meth:`local`; :meth:`template` drops the data."""

    __slots__ = ("shape", "dtype", "extents", "shards", "device")

    def __init__(self, shape: Sequence[int], dtype: torch.dtype,
                 extents: Sequence[Sequence[Sequence[int]]],
                 shards: Optional[Sequence[torch.Tensor]] = None,
                 device=None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.extents = tuple(tuple((int(a), int(b)) for a, b in e)
                             for e in extents)
        for e in self.extents:
            if len(e) != len(self.shape) or any(
                    not 0 <= a <= b <= s for (a, b), s in zip(e, self.shape)):
                raise ValueError(f"shard extents {e} do not lie in the "
                                 f"global shape {self.shape}")
        self.shards = None if shards is None else list(shards)
        if self.shards is not None:
            if len(self.shards) != len(self.extents):
                raise ValueError(f"{len(self.shards)} shards for "
                                 f"{len(self.extents)} extents")
            for t, e in zip(self.shards, self.extents):
                if tuple(t.shape) != tuple(b - a for a, b in e) \
                        or t.dtype != dtype:
                    raise ValueError(f"shard {tuple(t.shape)} {t.dtype} does "
                                     f"not match extents {e} {dtype}")
        if device is None and self.shards:
            device = self.shards[0].device
        self.device = torch.device("cpu" if device is None
                                   or torch.device(device).type == "meta"
                                   else device)

    @classmethod
    def rank_major(cls, stack: torch.Tensor, dim: int = 0) -> "Sharded":
        """A rank-major stack ``[n, ...]`` as n shards of one global leaf
        along ``dim`` of a rank's slice: shard r is ``stack[r]``, at
        ``[r k, (r + 1) k)`` of that dim (k its size) and whole in the
        others.  The ZeRO-1 / ZeRO-3 flat states ``[n, shard]`` take
        ``dim=0``; an FSDP leaf sharded on dim 1 takes ``dim=1``."""
        n, local = stack.shape[0], tuple(stack.shape[1:])
        if not 0 <= dim < len(local):
            raise ValueError(f"dim {dim} out of range for a rank's slice "
                             f"{local}")
        shape = tuple(s * n if d == dim else s for d, s in enumerate(local))
        extents = [[(r * s, (r + 1) * s) if d == dim else (0, s)
                    for d, s in enumerate(local)] for r in range(n)]
        return cls(shape, stack.dtype, extents,
                   shards=[stack[r] for r in range(n)], device=stack.device)

    @classmethod
    def local(cls, shard: torch.Tensor, rank: int, n: int,
              dim: int = 0) -> "Sharded":
        """This process's shard of a leaf split in ``n`` equal parts along
        ``dim``, the part of ``rank`` (the process-world form: each
        process of a gloo or NCCL world holds its own)."""
        local = tuple(shard.shape)
        if not 0 <= rank < n or not 0 <= dim < len(local):
            raise ValueError(f"rank {rank} of {n}, dim {dim} of {local}")
        shape = tuple(s * n if d == dim else s for d, s in enumerate(local))
        extents = [[(rank * s, (rank + 1) * s) if d == dim else (0, s)
                    for d, s in enumerate(local)]]
        return cls(shape, shard.dtype, extents, shards=[shard],
                   device=shard.device)

    def template(self, device=None) -> "Sharded":
        """The same layout without data: :func:`restore_sharded`'s
        template, the restored shards on ``device`` (default: where these
        shards were)."""
        return Sharded(self.shape, self.dtype, self.extents,
                       device=self.device if device is None else device)

    def stack(self) -> torch.Tensor:
        """The shards stacked rank-major, ``[n, ...]``."""
        if self.shards is None:
            raise ValueError("a template holds no shards")
        return torch.stack(self.shards)

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, "
                f"{len(self.extents)} shards"
                f"{'' if self.shards is not None else ', template'})")


def _proc() -> int:
    return runtime.rank() if runtime.is_initialized() else 0


def _nproc() -> int:
    return runtime.size() if runtime.is_initialized() else 1


def _faults_mod():
    """The injecting fault layer, through ``sys.modules`` (this module
    never imports it), or None.  Gated on ``injecting()``, a plan loaded:
    the ``ckpt.*`` sites are injection only, so ``faults="policy"`` pays
    no staging copies for a fire() that can land nothing."""
    mod = sys.modules.get(_PKG + ".faults")
    if mod is not None and mod.injecting():
        return mod
    return None


def _redundancy():
    """The one string compare of the durable-checkpoint opt-in: "off"
    returns None and ``utils/durable.py`` is never imported."""
    if runtime.effective_config().ckpt_redundancy == "off":
        return None
    from . import durable

    return durable


def _fence_check(path: str) -> None:
    """Epoch fencing, one ``sys.modules`` lookup a save: with a fence
    armed (``faults/fencing.py``) a writer whose view epoch is behind the
    board's committed epoch raises ``FencedWriterError`` before any byte
    lands."""
    mod = sys.modules.get(_PKG + ".faults.fencing")
    if mod is not None:
        mod.check_save(path)


def _writable_u8(data):
    """A writable uint8 numpy view over ``data`` for the fault sites
    (``corrupt_silent`` flips real bits in the staged buffer).  Copies
    only a read-only buffer."""
    mv = memoryview(data)
    if mv.readonly:
        mv = memoryview(bytearray(mv))
    return np.frombuffer(mv, dtype=np.uint8)


def _write_atomic(path: str, data) -> None:
    """Commit ``data`` (bytes-like) to ``path`` by tmp, write, fsync and
    atomic rename; with a plan loaded, under the ``ckpt.write`` site."""
    mod = _faults_mod()
    if mod is not None:
        u8 = _writable_u8(data)
        mod.ckpt_write(path, u8, lambda: _commit(path, lambda f: f.write(u8)))
        return
    _commit(path, lambda f: f.write(data))


def _read_npz_bytes(path: str):
    """A checkpoint npz read back as a read-only bytes-like buffer,
    through the ``ckpt.read`` site when a plan is loaded (injected rot
    lands in the returned buffer, as on-disk rot would)."""
    mod = _faults_mod()
    with open(path, "rb") as f:
        if mod is None:
            return f.read()
        buf = bytearray(os.fstat(f.fileno()).st_size)
        del buf[f.readinto(buf):]
    mod.ckpt_read(path, np.frombuffer(buf, dtype=np.uint8))
    return memoryview(buf).toreadonly()


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
    if isinstance(leaf, (torch.Tensor, Sharded)):
        return str(leaf.dtype).replace("torch.", "")
    return np.asarray(leaf).dtype.name


def _host_arrays(pairs) -> list:
    """The numpy arrays of ``pairs`` (key, leaf: a tensor on any device, a
    numpy array or a scalar): the tensors on the card copied to pinned host
    memory on the current stream with one wait at the end, bfloat16 as its
    raw bits (``|V2``)."""
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
    out = []
    for key, x in staged:
        if isinstance(x, torch.Tensor):
            x = x.contiguous()
            out.append((key, x.view(torch.int16).numpy().view("V2")
                        if x.dtype == torch.bfloat16 else x.numpy()))
        else:
            out.append((key, np.asarray(x)))
    return out


def _snapshot(tree) -> Tuple[dict, dict]:
    """({path key: numpy array}, {path key: dtype name}) of ``tree``'s
    leaves (None skipped)."""
    pairs = [(k, x) for k, x in _keyed_leaves(tree) if x is not None]
    dtypes = {k: _dtype_name(x) for k, x in pairs}
    return dict(_host_arrays(pairs)), dtypes


def _meta(step: int, arrays: dict, dtypes: dict) -> dict:
    return {"step": step, "keys": sorted(arrays.keys()), "dtypes": dtypes}


def _npz_buffer(arrays: dict):
    """The serialized npz of ``arrays``: a writable memoryview."""
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getbuffer()


_TMP_REAP_AGE_S = 600.0


def _reap_stale_tmp(directory: str) -> None:
    """Remove orphaned writer-unique staging files (``*.tmp.<pid>``) left
    by writers that died between staging and rename.  Age-gated: a live
    concurrent writer's staging file is seconds old.  The exact ``.tmp``
    suffix (the injected torn-write artifact) is left alone."""
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
    """Write a checkpoint; returns the npz path.  Off mode with no plan
    loaded streams the npz straight to its staging file (no second
    in-memory copy); both files are fsync'd before their renames.  With
    ``Config.ckpt_redundancy`` on, the serialized bytes are digest-stamped
    in the record, mirrored to the buddy locations and old steps pruned
    (``utils/durable.py``)."""
    os.makedirs(directory, exist_ok=True)
    proc = _proc()
    path = os.path.join(directory, f"ckpt_{step}_p{proc}.npz")
    _fence_check(path)
    arrays, dtypes = _snapshot(tree)
    meta = _meta(step, arrays, dtypes)
    dur = _redundancy()
    if dur is None and _faults_mod() is None:
        _commit(path, lambda f: np.savez(f, **arrays))
    else:
        buf = _npz_buffer(arrays)
        del arrays
        if dur is not None:
            dur.save_pair(directory, f"ckpt_{step}_p{proc}", buf, meta,
                          step=step, proc=proc)
            return path
        _write_atomic(path, buf)
    _write_atomic(path[:-4] + ".json", json.dumps(meta).encode())
    return path


class CheckpointHandle:
    """Future for one async checkpoint (its data and metadata writes).

    ``on_durable`` (the durable mode's retention) runs once, after every
    write has landed: pruning older steps earlier would race their
    still-queued writes on the FIFO writer.  A handle never waited skips
    its prune; the next save's prune recomputes the whole list."""

    def __init__(self, handles, path: str, on_durable=None):
        self._handles = handles
        self.path = path
        self._on_durable = on_durable

    def done(self) -> bool:
        return all(h.done() for h in self._handles)

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until the checkpoint is on disk; returns the npz path.
        ``timeout`` bounds the whole call (a deadline shared by every
        write).  Raises ``OSError`` if a write failed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for h in self._handles:
            h.wait(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        if self._on_durable is not None:
            cb, self._on_durable = self._on_durable, None
            cb()
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


def _submit(w, path: str, data, durable: bool):
    """One async-writer submission, through the ``ckpt.write`` site when a
    plan is loaded (the async twin of :func:`_write_atomic`; the native
    writer does tmp, fsync and rename itself)."""
    mod = _faults_mod()
    if mod is None:
        return w.submit(path, data, durable=durable)
    u8 = _writable_u8(data)
    return mod.ckpt_write(path, u8,
                          lambda: w.submit(path, u8, durable=durable))


def _submit_pair(directory: str, name: str, buf, meta: dict, *, step: int,
                 proc: int, durable: bool) -> CheckpointHandle:
    """``<name>.npz`` and ``<name>.json`` on the FIFO writer, through the
    durable mode when it is on."""
    dur = _redundancy()
    if dur is not None:
        return dur.submit_pair(_writer(), directory, name, buf, meta,
                               step=step, proc=proc, durable=durable)
    w = _writer()
    path = os.path.join(directory, name + ".npz")
    h_data = _submit(w, path, buf, durable)
    h_meta = _submit(w, os.path.join(directory, name + ".json"),
                     json.dumps(meta).encode(), durable)
    return CheckpointHandle((h_data, h_meta), path)


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
    name = f"ckpt_{step}_p{proc}"
    _fence_check(os.path.join(directory, name + ".npz"))
    arrays, dtypes = _snapshot(tree)
    meta = _meta(step, arrays, dtypes)
    return _submit_pair(directory, name, _npz_buffer(arrays), meta,
                        step=step, proc=proc, durable=durable)


def _scan_steps(directory: str, prefix: str, suffix: str,
                require_meta: bool) -> set:
    found = set()
    if not os.path.isdir(directory):
        return found
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(suffix):
            try:
                step = int(name[len(prefix):-len(suffix)])
            except ValueError:
                continue
            # A crash between the npz and json renames must not surface a
            # step the restore cannot read: where the restore needs the
            # record, only complete pairs count.
            if require_meta and not os.path.exists(
                    os.path.join(directory, name[:-4] + ".json")):
                continue
            found.add(step)
    return found


def _steps(directory: str, prefix: str, *, require_meta: bool) -> list:
    suffix = f"_p{_proc()}.npz"
    steps = _scan_steps(directory, prefix, suffix, require_meta)
    # Buddy mode: a step whose primary died with its storage is still
    # restorable (the restore repairs it from the buddy copy).
    dur = _redundancy()
    if dur is not None:
        for d in dur.scan_dirs(directory, _proc()):
            steps |= _scan_steps(d, prefix, suffix, require_meta)
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory, "ckpt_", require_meta=False)
    return steps[-1] if steps else None


def available_steps(directory: str) -> list:
    """All restorable steps for this process, ascending."""
    return _steps(directory, "ckpt_", require_meta=False)


def _as_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A stored array as a tensor on ``device``; a bfloat16 record's raw
    2-byte voids reinterpreted through their bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            and dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.asarray(arr)).to(device)


def _undo_void(arr: np.ndarray, dtype: str, leaf) -> Any:
    """A stored array as ``leaf``'s kind: a tensor on the leaf's device,
    else a numpy array (a bfloat16 record through the leaf's own dtype
    where it has one, else as uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        return _as_tensor(arr, dtype, leaf.device)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            and dtype == "bfloat16":
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


def _full_extents(shape) -> list:
    return [[0, int(s)] for s in shape]


def save_sharded(directory: str, tree: PyTree, *, step: int = 0,
                 durable: bool = True, wait: bool = True):
    """Checkpoint sharded leaves: each process writes only the shards it
    holds (a replicated copy, the same extents, saved once), with each
    leaf's global shape and dtype and the shards' extents in the record.
    A :class:`Sharded` leaf writes its shards; any other leaf is one shard
    of full extents.  Files ``shckpt_<step>_p<proc>.npz`` and ``.json`` go
    through the native writer (and the durable mode when it is on);
    ``wait=False`` returns the in-flight :class:`CheckpointHandle`."""
    os.makedirs(directory, exist_ok=True)
    proc = _proc()
    name = f"shckpt_{step}_p{proc}"
    _fence_check(os.path.join(directory, name + ".npz"))
    pairs, meta_leaves = [], {}
    for key, leaf in _keyed_leaves(tree):
        if leaf is None:
            continue
        if isinstance(leaf, Sharded):
            if leaf.shards is None:
                raise ValueError(f"{key!r}: a template holds no data")
            shards_meta, seen = [], set()
            for ext, t in zip(leaf.extents, leaf.shards):
                if ext in seen:
                    continue  # a replicated copy of the same shard
                seen.add(ext)
                nm = f"{key}//{len(shards_meta)}"
                pairs.append((nm, t))
                shards_meta.append({"extents": [list(e) for e in ext],
                                    "name": nm})
            shape = leaf.shape
        else:
            nm = f"{key}//0"
            pairs.append((nm, leaf))
            shape = tuple(leaf.shape) if hasattr(leaf, "shape") \
                else np.shape(leaf)
            shards_meta = [{"extents": _full_extents(shape), "name": nm}]
        meta_leaves[key] = {"shape": [int(s) for s in shape],
                            "dtype": _dtype_name(leaf),
                            "shards": shards_meta}
    buf = _npz_buffer(dict(_host_arrays(pairs)))
    del pairs
    handle = _submit_pair(directory, name, buf,
                          {"step": step, "leaves": meta_leaves}, step=step,
                          proc=proc, durable=durable)
    if wait:
        handle.wait()
    return handle


def latest_sharded_step(directory: str) -> Optional[int]:
    steps = _steps(directory, "shckpt_", require_meta=True)
    return steps[-1] if steps else None


def agree_min_step(local: int) -> int:
    """The MIN of an int over the port's world process group: the one
    collective the agreement protocols are built from (here and in
    ``restart.recover``).  Runs on every process unconditionally; callers
    encode "nothing available" as a sentinel (<= 0) and decide every later
    branch from the returned global value, so no process raises or falls
    back alone.  With one process it returns ``local``."""
    if _nproc() <= 1:
        return int(local)
    import torch.distributed as dist

    dev = runtime.device() if runtime.backend_name() == "nccl" \
        else torch.device("cpu")
    t = torch.tensor([int(local)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def _pair_exists(directory: str, step: int) -> bool:
    stem = os.path.join(directory, f"shckpt_{step}_p{_proc()}")
    return os.path.exists(stem + ".npz") and os.path.exists(stem + ".json")


def restore_sharded(directory: str, template: PyTree,
                    *, step: Optional[int] = None) -> PyTree:
    """Restore into ``template``'s layouts: a :class:`Sharded` template
    leaf gets each of its shards matched by extents from this process's
    file (no global copy is built); any other leaf is read as the one
    shard of full extents.  Restoring onto a layout other than the saved
    one raises ``ValueError`` naming the leaf.

    With ``step`` None: over several processes, the MIN of the processes'
    newest complete steps (:func:`agree_min_step`, on every process even
    with nothing saved); a corrupt agreed step raises for the caller's
    gang-level walk-back.  One process walks back past a corrupt or
    vanished newest step, recording each rejection."""
    if step is None:
        local = latest_sharded_step(directory)
        if _nproc() > 1:
            agreed = agree_min_step(-1 if local is None else local)
            if agreed < 0:
                raise FileNotFoundError(
                    f"no sharded checkpoints in {directory} on at least "
                    f"one process (local latest: {local})")
            if agreed != local and not _pair_exists(directory, agreed):
                raise FileNotFoundError(
                    f"processes disagree on the latest complete sharded "
                    f"step (local {local}, global min {agreed}) and step "
                    f"{agreed} is missing locally")
            step = agreed
        else:
            if local is None:
                raise FileNotFoundError(
                    f"no sharded checkpoints in {directory}")
            last_err: Optional[BaseException] = None
            for cand in reversed(_steps(directory, "shckpt_",
                                        require_meta=True)):
                try:
                    return _restore_sharded_at(directory, template, cand)
                except Exception as e:  # noqa: BLE001 — recorded, then
                    # the next older step
                    _record_walkback(cand, e)
                    last_err = e
            raise last_err
    return _restore_sharded_at(directory, template, step)


def _restore_sharded_at(directory: str, template: PyTree,
                        step: int) -> PyTree:
    name = f"shckpt_{step}_p{_proc()}"
    dur = _redundancy()
    if dur is not None:
        raw, meta_full = dur.read_pair(directory, name, step=step,
                                       proc=_proc())
        meta = (meta_full or {}).get("leaves")
        if meta is None:
            # A sharded pair cannot be read without its extents: a torn
            # record here is corruption, typed for the walk-back.
            raise CheckpointCorruptError(
                os.path.join(directory, name + ".json"), step=step,
                reason="shard metadata missing/unparseable")
        data = np.load(_io.BytesIO(raw))
    else:
        path = os.path.join(directory, name + ".npz")
        data = np.load(_io.BytesIO(_read_npz_bytes(path))) \
            if _faults_mod() is not None else np.load(path)
        with open(os.path.join(directory, name + ".json")) as f:
            meta = json.load(f)["leaves"]
    pairs = _keyed_leaves(template)
    missing = [k for k, x in pairs if x is not None and k not in meta]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    out = []
    for key, leaf in pairs:
        if leaf is None:
            out.append(None)
            continue
        info = meta[key]
        shape, dtype = tuple(info["shape"]), str(info["dtype"])
        _check_template(key, shape, dtype, leaf)
        by_extents = {tuple(tuple(e) for e in s["extents"]): s["name"]
                      for s in info["shards"]}
        wanted = leaf.extents if isinstance(leaf, Sharded) \
            else [tuple(tuple(e) for e in _full_extents(shape))]
        arrays = []
        for ext in wanted:
            nm = by_extents.get(tuple(tuple(e) for e in ext))
            if nm is None:
                raise ValueError(
                    f"{key!r}: no saved shard with extents {tuple(ext)} — "
                    f"the checkpoint was saved under a different sharding "
                    f"layout (have {sorted(by_extents)[:3]}...)")
            arrays.append(data[nm])
        if isinstance(leaf, Sharded):
            out.append(Sharded(shape, leaf.dtype, leaf.extents,
                               shards=[_as_tensor(a, dtype, leaf.device)
                                       for a in arrays], device=leaf.device))
        else:
            out.append(_undo_void(arrays[0], dtype, leaf))
    return _tree.unflatten(_tree.flatten(template)[1], out)


def restore(directory: str, template: PyTree,
            *, step: Optional[int] = None) -> PyTree:
    """Restore into the structure of ``template`` (values replaced): the
    latest step unless ``step`` is given.  With ``Config.ckpt_redundancy``
    on, the file's recorded digest is checked before the bytes are parsed;
    a mismatch repairs bit-identically from a buddy copy that verifies
    ("buddy") and otherwise raises :class:`CheckpointCorruptError`."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    proc = _proc()
    path = os.path.join(directory, f"ckpt_{step}_p{proc}.npz")
    dur = _redundancy()
    if dur is not None:
        raw, meta_full = dur.read_pair(directory, f"ckpt_{step}_p{proc}",
                                       step=step, proc=proc)
        data = np.load(_io.BytesIO(raw))
        dtypes = (meta_full or {}).get("dtypes", {})
    else:
        data = np.load(_io.BytesIO(_read_npz_bytes(path))) \
            if _faults_mod() is not None else np.load(path)
        # The recorded dtypes are the authority for reinterpreting npz's
        # void-encoded bfloat16; a checkpoint without the record falls
        # back to the template's dtype.
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


# ---------------------------------------------------------------------------
# Recovery evidence and retention protection
# ---------------------------------------------------------------------------


def walkback_reason(e: BaseException) -> str:
    """Why a restore attempt rejected a step, the walk-back's evidence
    label: ``corrupt`` (the typed digest failure, an unparseable npz, an
    I/O error), ``template_mismatch``, ``missing``, else the type name."""
    import zipfile

    if isinstance(e, CheckpointCorruptError):
        return "corrupt"
    if isinstance(e, TemplateMismatchError):
        return "template_mismatch"
    if isinstance(e, (FileNotFoundError, KeyError)):
        return "missing"
    if isinstance(e, (ValueError, OSError, zipfile.BadZipFile)):
        return "corrupt"
    return type(e).__name__


def _record_walkback(step: int, e: BaseException) -> None:
    """One rejected step of a recovery walk-back through the obs shim
    (``tm_ckpt_walkback_total{reason=...}`` and a ``ckpt`` flight event;
    nothing with obs off)."""
    from . import telemetry

    telemetry.emit("record_ckpt", "walkback", step=int(step),
                   reason=walkback_reason(e))


_PROTECT_LOCK = threading.Lock()
_PROTECTED: dict = {}  # directory -> the step a recovery settled on


def protect_step(directory: str, step: int) -> None:
    """Pin ``step`` against retention pruning in ``directory``
    (``restart.recover`` pins the step it settled on)."""
    with _PROTECT_LOCK:
        _PROTECTED[os.path.abspath(directory)] = int(step)


def protected_step(directory: str) -> Optional[int]:
    with _PROTECT_LOCK:
        return _PROTECTED.get(os.path.abspath(directory))


def replicate_for(directory: str, step: int, dst_procs: Sequence[int],
                  *, src_proc: Optional[int] = None) -> None:
    """Seed the checkpoint files of ``dst_procs`` at ``step`` from
    ``src_proc``'s (default: this process's): a joiner's recovery reads
    only files under its own rank.  Off mode copies the npz by tmp and
    atomic rename; with ``Config.ckpt_redundancy`` on, the source bytes
    are verified first (repaired from a buddy copy if they rotted) and each
    seeded rank gets the whole pair plus its own buddy mirrors, with no
    retention pass."""
    src = src_proc if src_proc is not None else _proc()
    dur = _redundancy()
    if dur is not None:
        raw, meta = dur.read_pair(directory, f"ckpt_{step}_p{src}",
                                  step=step, proc=src)
        for r in dst_procs:
            dur.save_pair(directory, f"ckpt_{step}_p{int(r)}", raw, meta,
                          step=step, proc=int(r), prune_old=False)
        return
    src_path = os.path.join(directory, f"ckpt_{step}_p{src}.npz")
    if _faults_mod() is None:
        import shutil

        for r in dst_procs:
            dst = os.path.join(directory, f"ckpt_{step}_p{int(r)}.npz")
            tmp = f"{dst}.tmp.{os.getpid()}"
            shutil.copyfile(src_path, tmp)
            os.replace(tmp, dst)
        _reap_stale_tmp(directory)
        return
    raw = _read_npz_bytes(src_path)
    for r in dst_procs:
        _write_atomic(os.path.join(directory, f"ckpt_{step}_p{int(r)}.npz"),
                      raw)
