"""Payload and checkpoint-file digests: blake2b over host bytes (the JAX
package's ``faults/integrity.py``; docs/CHECKPOINT_TORCH.md).

:func:`digest_bytes` is the one digest home of the durable checkpoints
(``utils/durable.py`` records it in each file's metadata and checks it on
every restore): the same bytes give the JAX package's hex digest, so each
package verifies the other's files.  :func:`digest` hashes a host payload
with its dtype and shape (a CPU tensor hashes as the numpy array of the
same values does), and :func:`verify` is its receiver-side check, raising
the transient :class:`IntegrityError`.

Imported only while ``Config.ckpt_redundancy`` is on or the wire guard
is armed (``Config.guard`` "wire" | "full": the ``wire_guard=`` readers
of the staged and PS paths, ``faults/__init__.py``): otherwise this module
never loads.
Telemetry (``tm_guard_*``) rides :mod:`torchmpi_tpu_torch.obs` through
``utils/telemetry.py`` when obs is active.
"""

from __future__ import annotations

import hashlib
import time
from typing import Optional

import numpy as np

from ..utils import telemetry
from .inject import TransientFault

DIGEST_BYTES = 16


class IntegrityError(TransientFault):
    """A staged payload failed its end-to-end digest check: bits changed
    between the sender's staging and the receiver's consume.  Transient (a
    retry stages again from the device buffers) and carries
    ``site`` / ``peer`` / ``bucket`` for the health ledger and blame."""

    def __init__(self, site: str, *, peer: str = "", bucket: int = 0,
                 expect: str = "", got: str = ""):
        self.site = site
        self.peer = peer
        self.bucket = int(bucket)
        self.expect = expect
        self.got = got
        peer_s = f" (peer {peer})" if peer else ""
        super().__init__(
            f"{site}{peer_s}: payload integrity check failed — digest "
            f"{got[:12]} != staged {expect[:12]} (bucket {bucket}); "
            f"bits changed between staging and consume")


def digest_bytes(data) -> str:
    """blake2b hex digest (16 bytes) over a raw byte buffer: the
    checkpoint-file digest.  No shape or dtype salt: the bytes are the
    artifact."""
    h = hashlib.blake2b(digest_size=DIGEST_BYTES)
    h.update(memoryview(data).cast("B"))
    return h.hexdigest()


def _host_view(buf):
    """(dtype name, shape, C-contiguous uint8 numpy view) of a numpy array
    or a CPU tensor (bfloat16 through its bits)."""
    if type(buf).__module__.startswith("torch"):
        import torch

        t = buf.detach()
        if t.device.type != "cpu":
            raise ValueError("digest: a tensor on the card has no host "
                             "bytes; stage it first")
        name = str(t.dtype).replace("torch.", "")
        flat = t.contiguous().reshape(-1).view(torch.uint8).numpy()
        return name, tuple(t.shape), flat
    a = np.asarray(buf)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    return str(a.dtype), a.shape, a.view(np.uint8).reshape(-1)


def digest(buf) -> str:
    """blake2b hex digest over a payload's bytes plus its dtype and shape
    (so a torn reshape cannot alias a clean buffer): a numpy array, or a
    CPU tensor, which digests as the numpy array of its values."""
    name, shape, flat = _host_view(buf)
    h = hashlib.blake2b(digest_size=DIGEST_BYTES)
    h.update(name.encode())
    h.update(str(shape).encode())
    h.update(flat.data)
    return h.hexdigest()


def verify(site: str, buf, expect: str, *, peer: str = "",
           bucket: int = 0) -> str:
    """Receiver-side check: re-hash ``buf`` and compare with the sender's
    ``expect``.  Records the verify latency and a ``guard`` event; a
    mismatch bumps ``tm_guard_verify_failed_total`` and raises
    :class:`IntegrityError`."""
    t0 = time.monotonic()
    got = digest(buf)
    nbytes = int(_host_view(buf)[2].nbytes)
    telemetry.emit("record_guard_latency", site, time.monotonic() - t0)
    if got != expect:
        record("verify_failed", site, peer=peer, digest=got, nbytes=nbytes)
        raise IntegrityError(site, peer=peer, bucket=bucket, expect=expect,
                             got=got)
    record("verified", site, peer=peer, digest=got, nbytes=nbytes)
    return got


def healed(site: str, *, peer: str = "") -> None:
    """A retried exchange whose earlier attempt failed its digest check
    completed clean (``tm_guard_healed_total``)."""
    record("healed", site, peer=peer)


def record(action: str, site: str, *, peer: str = "", digest: str = "",
           nbytes: int = 0) -> None:
    """``tm_guard_*`` through obs, when obs is active."""
    telemetry.emit("record_guard", action, site, peer=peer, digest=digest,
                   nbytes=nbytes)


class Watch:
    """Per-exchange heal tracker: counts integrity failures across an
    exchange's attempts and emits ``healed`` when a later attempt
    completes clean."""

    __slots__ = ("site", "peer", "failures")

    def __init__(self, site: str, peer: str = ""):
        self.site = site
        self.peer = peer
        self.failures = 0

    def note(self, e: Optional[BaseException]) -> None:
        if isinstance(e, IntegrityError):
            self.failures += 1

    def settle(self) -> None:
        """Call on attempt success: emits healed if an earlier attempt
        failed its digest check."""
        if self.failures:
            healed(self.site, peer=self.peer)
            self.failures = 0
