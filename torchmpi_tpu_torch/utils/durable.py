"""Durable checkpoints: digests, buddy mirrors, retention (the JAX
package's ``utils/durable.py``; docs/CHECKPOINT_TORCH.md).

``utils/checkpoint.py`` routes its saves and restores through this module
while ``Config.ckpt_redundancy`` is on (one string compare at each entry;
"off" never imports it):

- **integrity** ("verify" and "buddy"): a blake2b digest of the serialized
  npz bytes (``faults.integrity.digest_bytes``) is recorded in each file's
  json and checked on every restore; a mismatch is a typed
  ``checkpoint.CheckpointCorruptError``, walk-back evidence for
  ``restart.recover``, never a silent garbage restore.
- **redundancy** ("buddy"): each process mirrors its pair to
  ``Config.ckpt_buddies`` buddy locations, held by ranks ``(proc + 1 ..
  K) mod world`` (a world of one mirrors to one separate location under
  ``<dir>/buddies/``).  A restore whose primary is missing or corrupt
  repairs from the first buddy copy that verifies, rewritten over the
  primary by the same tmp + fsync + rename, so the repair is bit-identical
  and durable.
- **retention**: ``Config.ckpt_keep`` keeps the newest K steps a process
  (primaries and mirrors), never the step recovery settled on
  (``checkpoint.protect_step``).

File names and json keys are the JAX package's, so each package verifies,
repairs from and prunes the other's files.  Telemetry
(``tm_ckpt_{saved,verified,verify_failed,repaired,pruned,walkback}_total``
and ``ckpt`` flight events) goes through ``utils/telemetry.emit``; the
``ckpt.write`` / ``ckpt.read`` fault sites sit one layer down, in
``checkpoint._write_atomic`` / ``_read_npz_bytes``, so injected faults hit
primaries, mirrors and repairs alike.
"""

from __future__ import annotations

import json
import os
import threading
from typing import List, Optional, Tuple

from .. import runtime
from ..faults import integrity
from . import checkpoint, telemetry


def _emit(action: str, *, step: int = 0, reason: str = "") -> None:
    telemetry.emit("record_ckpt", action, step=step, reason=reason)


def buddy_holders(proc: int, world: Optional[int] = None,
                  k: Optional[int] = None) -> List[int]:
    """The ranks holding ``proc``'s buddy copies: ``(proc + 1 .. K) mod
    world``, never ``proc`` itself, except in a world of one process,
    where the one "holder" is a separate location under the same rank
    (it guards against file loss and rot, not host loss)."""
    if world is None:
        world = checkpoint._nproc()
    if k is None:
        k = runtime.effective_config().ckpt_buddies
    holders = []
    for i in range(1, int(k) + 1):
        h = (int(proc) + i) % int(world)
        if h != int(proc) and h not in holders:
            holders.append(h)
    return holders or [int(proc)]


def buddy_dir(directory: str, holder: int) -> str:
    """The on-disk stand-in for rank ``holder``'s checkpoint storage."""
    return os.path.join(directory, "buddies", f"r{int(holder)}")


def _per_file_payloads(data, n: int) -> list:
    """``n`` buffers for ``n`` writes of the same bytes.  With a plan
    loaded each file gets its own copy (injected rot must rot one storage
    location, not the buffer feeding every mirror); the last write takes
    ``data`` itself, written after every copy was made.  Without a plan
    the buffer is shared."""
    if checkpoint._faults_mod() is None:
        return [data] * n
    return [bytearray(memoryview(data)) for _ in range(n - 1)] + [data]


def _pair_targets(directory: str, proc: int, mode: str) -> List[str]:
    """The primary directory, then each buddy location (made on demand)."""
    targets = [directory]
    if mode == "buddy":
        for h in buddy_holders(proc):
            d = buddy_dir(directory, h)
            os.makedirs(d, exist_ok=True)
            targets.append(d)
    return targets


class _Digest:
    """The digest of ``data`` taken on a thread (blake2b releases the
    GIL), beside the first npz write: a checkpoint's digest and its
    primary write each take seconds at a model's size."""

    def __init__(self, data):
        self._out: dict = {}
        self._th = threading.Thread(target=self._run, args=(data,),
                                    daemon=True)
        self._th.start()

    def _run(self, data) -> None:
        try:
            self._out["hex"] = integrity.digest_bytes(data)
        except BaseException as e:  # noqa: BLE001 — raised by result()
            self._out["err"] = e

    def result(self) -> str:
        self._th.join()
        if "err" in self._out:
            raise self._out["err"]
        return self._out["hex"]


def _write_pairs(write, directory: str, name: str, data,
                 meta: Optional[dict], proc: int, mode: str) -> None:
    """``write(path, buffer)`` of each location's npz, then its json with
    the digest of ``data`` in it.  The digest is of the bytes the saver
    meant to persist: taken before a fault site can flip bits in ``data``
    (the last write's buffer), the earlier writes' own copies overlapping
    it."""
    digest = _Digest(data)
    targets = _pair_targets(directory, proc, mode)
    payloads = _per_file_payloads(data, len(targets))
    armed = checkpoint._faults_mod() is not None
    meta_bytes = None
    for d, payload in zip(targets, payloads):
        if armed and payload is data:
            digest.result()
        write(os.path.join(d, name + ".npz"), payload)
        if meta_bytes is None:
            meta = dict(meta or {})
            meta["digest"] = digest.result()
            meta_bytes = json.dumps(meta).encode()
        write(os.path.join(d, name + ".json"), meta_bytes)


def save_pair(directory: str, name: str, data, meta: Optional[dict], *,
              step: int, proc: int, prune_old: bool = True) -> str:
    """Commit one digest-stamped pair (``<name>.npz`` and ``<name>.json``)
    to the primary directory and every buddy location, then apply
    retention (``prune_old``)."""
    cfg = runtime.effective_config()
    _write_pairs(checkpoint._write_atomic, directory, name, data, meta,
                 proc, cfg.ckpt_redundancy)
    _emit("saved", step=step)
    if prune_old:
        prune(directory, name.split("_", 1)[0] + "_", proc, cfg.ckpt_keep)
    return os.path.join(directory, name + ".npz")


def submit_pair(writer, directory: str, name: str, data, meta: dict, *,
                step: int, proc: int, durable: bool = True):
    """The async twin of :func:`save_pair`: the primary pair and its
    mirrors on the FIFO writer (each npz before its json), one
    ``checkpoint.CheckpointHandle`` over every write.  Retention waits for
    the handle's ``wait()``: pruning from the caller would race older
    steps' queued writes, whose renames would bring the files back."""
    cfg = runtime.effective_config()
    handles = []
    _write_pairs(lambda path, buf: handles.append(checkpoint._submit(
        writer, path, buf, durable)), directory, name, data, meta, proc,
        cfg.ckpt_redundancy)
    _emit("saved", step=step)
    on_durable = None
    if cfg.ckpt_keep > 0:
        prefix, keep = name.split("_", 1)[0] + "_", cfg.ckpt_keep

        def on_durable():
            prune(directory, prefix, proc, keep)
    return checkpoint.CheckpointHandle(
        handles, os.path.join(directory, name + ".npz"),
        on_durable=on_durable)


def _load_meta(path: str) -> Optional[dict]:
    """The json record, or None when missing or unparseable (a torn json
    is absent evidence: a buddy's digest can still vouch for the bytes)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _read_verified(d: str, name: str) -> Tuple[bytes, Optional[dict],
                                               Optional[str]]:
    """One location's pair read and checked: ``(bytes, meta, error)``,
    ``error`` None on success, else why this copy was rejected."""
    meta = _load_meta(os.path.join(d, name + ".json"))
    try:
        raw = checkpoint._read_npz_bytes(os.path.join(d, name + ".npz"))
    except OSError as e:
        return b"", meta, f"unreadable ({e})"
    expect = (meta or {}).get("digest", "")
    if expect:
        got = integrity.digest_bytes(raw)
        if got != expect:
            return raw, meta, f"digest {got[:12]} != {expect[:12]}"
    elif meta is None:
        # No digest anywhere for this copy: only a legacy primary may pass
        # (the caller decides); buddies are always written stamped.
        return raw, None, None
    return raw, meta, None


def read_pair(directory: str, name: str, *, step: int,
              proc: int) -> Tuple[bytes, Optional[dict]]:
    """Verified read of one pair, repairing from a buddy copy when the
    primary is missing or fails its digest ("buddy").  A primary with no
    digest of its own (its json lost or torn) is not trusted blind in
    buddy mode: the first buddy that verifies either vouches for its bytes
    (the digests match: the primary's json is re-seeded) or vetoes them
    (the primary is repaired); only with no verifiable buddy does it pass
    as a legacy checkpoint.  Returns ``(npz bytes, record)``; raises
    ``checkpoint.CheckpointCorruptError`` when no copy verifies, or
    ``FileNotFoundError`` when none exists."""
    cfg = runtime.effective_config()
    path = os.path.join(directory, name + ".npz")
    primary_exists = os.path.exists(path)
    first_err = ""
    unvouched = None  # a readable primary with no digest of its own
    if primary_exists:
        raw, meta, err = _read_verified(directory, name)
        if err is None:
            if (meta or {}).get("digest"):
                _emit("verified", step=step)
                return raw, meta
            if cfg.ckpt_redundancy != "buddy":
                return raw, meta  # a legacy pair: nothing to check against
            unvouched = (raw, meta)
        else:
            first_err = err
            _emit("verify_failed", step=step, reason="primary")
    if cfg.ckpt_redundancy == "buddy":
        for h in buddy_holders(proc):
            d = buddy_dir(directory, h)
            if not os.path.exists(os.path.join(d, name + ".npz")):
                continue
            raw, meta, err = _read_verified(d, name)
            if err is not None or not (meta or {}).get("digest"):
                _emit("verify_failed", step=step, reason=f"buddy_r{h}")
                continue
            meta_bytes = json.dumps(meta).encode()
            if unvouched is not None and \
                    integrity.digest_bytes(unvouched[0]) == meta["digest"]:
                # The buddy vouches for the digestless primary: the same
                # bytes, so only the primary's json is re-seeded.
                try:
                    checkpoint._write_atomic(
                        os.path.join(directory, name + ".json"), meta_bytes)
                except OSError:
                    pass
                _emit("verified", step=step)
                return unvouched[0], meta
            if unvouched is not None:
                # The buddy vetoes the primary's bytes: rot after all.
                first_err = "no local digest; buddy digest differs"
                _emit("verify_failed", step=step, reason="primary")
                unvouched = None
            # Repair: the primary pair rewritten bit-identically, so the
            # next restore (and any peer seeded from this rank) finds it.
            try:
                checkpoint._write_atomic(path, raw)
                checkpoint._write_atomic(
                    os.path.join(directory, name + ".json"), meta_bytes)
            except OSError:
                pass  # the bytes are good even if the disk still is not
            _emit("repaired", step=step, reason=f"buddy_r{h}")
            return raw, meta
        if unvouched is not None:
            # No verifiable buddy to vouch or veto: the legacy acceptance.
            return unvouched
    if not primary_exists:
        raise FileNotFoundError(
            f"{path}: no checkpoint copy exists (primary missing, no "
            f"verifiable buddy)")
    raise checkpoint.CheckpointCorruptError(
        path, step=step,
        reason=f"primary {first_err}; no buddy copy verified")


def prune(directory: str, prefix: str, proc: int, keep: int) -> None:
    """Keep the newest ``keep`` of one process's ``prefix`` steps
    (primaries and buddy mirrors), never the protected step.  ``keep <=
    0`` keeps everything."""
    if keep <= 0:
        return
    suffix = f"_p{int(proc)}.npz"
    try:
        names = os.listdir(directory)
    except OSError:
        return
    steps = []
    for fname in names:
        if fname.startswith(prefix) and fname.endswith(suffix):
            try:
                steps.append(int(fname[len(prefix):-len(suffix)]))
            except ValueError:
                continue
    steps.sort()
    protected = checkpoint.protected_step(directory)
    dirs = [directory] + [buddy_dir(directory, h)
                          for h in buddy_holders(proc)]
    for s in [s for s in steps[:-keep] if s != protected]:
        name = f"{prefix}{s}_p{int(proc)}"
        for d in dirs:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(d, name + ext))
                except OSError:
                    pass
        _emit("pruned", step=s)


def scan_dirs(directory: str, proc: int) -> List[str]:
    """The buddy locations whose copies count as restorable steps for
    ``proc`` in "buddy" mode (a step that survives only on a buddy is
    still a step)."""
    if runtime.effective_config().ckpt_redundancy != "buddy":
        return []
    return [d for d in (buddy_dir(directory, h)
                        for h in buddy_holders(proc)) if os.path.isdir(d)]
