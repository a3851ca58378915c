"""Hot-state replication tier: RAM-buddy recovery and live rank migration
(the JAX package's ``hotstate/``; docs/HOTSTATE_TORCH.md).

The durable checkpoints (``utils/checkpoint.py``, ``utils/durable.py``)
bottom every recovery out in a filesystem restore, so the time to recover
is gated on the save interval and the disk.  This tier sits above them:
after each completed step a rank ships its state *delta* to its buddy's
RAM, int8-quantized with ``compress``'s host scale plus an exact sparse
correction, so the reconstruction is bit-identical to the sender's state,
tagged ``(step, epoch, incarnation, blake2b digest)`` and epoch-fenced
like board writes.  ``restart.recover`` (and through it the elastic
driver) consults the RAM tier first and falls back to the disk buddies
and then the primaries only when the RAM copy is missing, stale or
corrupt: the three-rung recovery ladder, each rung counted
(``tm_hotstate_{streamed,restored,fallback_disk,verify_failed,...}_total``).

The same stream drives planned live migration: :func:`migrate` drains a
rank onto a spare at a step boundary (pre-seed the spare's RAM from the
stream, admit it, retire the source) with zero checkpoint rollback; the
drain is lease-visible (watchdog state ``migrating``) so ``obs/tool.py
blame --live`` renders it apart from parked or dead ranks.

Blobs and digests are the JAX package's byte for byte: leaves in
``_tree.flatten``'s order (dict keys sorted, as ``jax.tree`` flattens),
the digest over ``"<dtype.str>:<shape>;"`` headers and the leaves' bytes,
bfloat16 leaves shipped raw under the header ``<V2`` (the JAX package's
``ml_dtypes`` kind ``"V"``), float16 / float32 / float64 leaves as deltas,
integer and empty leaves raw.  On the host a bfloat16 leaf is a numpy
``V2`` array.  The pack of a leaf that lies on the card runs on the card
(:func:`_pack_delta`: the sender's mirror stays there and only the packed
blob is copied to the host, one host sync for all leaves' maxima); the
numpy pack is its plain version and gives the same bytes.  The digest is
taken on a thread beside the pack and joined before the message is
delivered.

Off by default and never imported when off: ``Config.hotstate`` is the
consent gate of a driver layer the user enables (:func:`enable`); the
dispatch path has no branch on it.  ``restart.recover`` and
``elastic.run_elastic`` reach an armed replicator only through
``sys.modules`` lookups.

Fault surface (docs/FAULTS_TORCH.md): every message crosses the
``hotstate.send`` (sender) and ``hotstate.recv`` (buddy) payload sites:
``drop`` loses the message (the next publish for that rank is forced to a
full snapshot), ``corrupt_silent`` flips real bits in the packed payload
(the digest verify catches it at restore time and the ladder falls to the
disk rung), ``stall`` wedges the stream where the watchdog can see it.
Not retried: a lost replica costs a rung, never a step.
"""

from __future__ import annotations

import hashlib
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _tree, runtime
from ..utils import telemetry

PyTree = Any
_PKG = __name__.rsplit(".", 1)[0]

# bfloat16 on the host: numpy has no bfloat16 without ml_dtypes, so a
# bfloat16 leaf is held as a void array of its bytes; its digest header is
# the JAX package's ``ml_dtypes.bfloat16`` one.
_BF16 = np.dtype("V2")
_BF16_STR = "<V2"

_NP_OF_TORCH = {
    torch.float64: np.dtype(np.float64), torch.float32: np.dtype(np.float32),
    torch.float16: np.dtype(np.float16), torch.bfloat16: _BF16,
    torch.int64: np.dtype(np.int64), torch.int32: np.dtype(np.int32),
    torch.int16: np.dtype(np.int16), torch.int8: np.dtype(np.int8),
    torch.uint8: np.dtype(np.uint8), torch.bool: np.dtype(np.bool_),
}


class HotStateMiss(RuntimeError):
    """No usable RAM replica (missing, stale, or every candidate failed
    its digest verify): the caller falls to the disk rung."""


def _require_on():
    """Every public entry point's consent gate (``Config.hotstate``: a
    driver layer's knob, as ``elastic``'s)."""
    cfg = runtime.effective_config()
    if cfg.hotstate == "off":
        raise RuntimeError(
            "torchmpi_tpu_torch.hotstate requires Config.hotstate='on' (or "
            "TORCHMPI_TPU_HOTSTATE=1) — the hot-state tier is opt-in; "
            "see docs/HOTSTATE_TORCH.md")
    return cfg


def _record(event: str, *, step: int = 0, peer: str = "",
            reason: str = "") -> None:
    """tm_hotstate_* through obs when active (the telemetry shim gates on
    ``sys.modules``: this module never imports obs)."""
    telemetry.emit("record_hotstate", event, step=step, peer=peer,
                   reason=reason)


def _faults_mod():
    """The armed fault layer, or None (``sys.modules``: never imported)."""
    mod = sys.modules.get(_PKG + ".faults")
    return mod if (mod is not None and mod.active()) else None


def _fence_check(epoch: int) -> None:
    """Epoch-fence a stream write like a board write: a publisher whose
    view epoch is behind the board's committed epoch must not land
    replicas the survivors could mistake for fresh state.  One
    ``sys.modules`` lookup: quorum-off sessions never import fencing."""
    fz = sys.modules.get(_PKG + ".faults.fencing")
    if fz is None:
        return
    fence = fz.current()
    if fence is not None:
        fence.check(epoch=epoch, what="hotstate stream")


def _buddy_holders(rank: int, world: int, k: int) -> List[int]:
    """Ranks ``(rank+1..k) mod world``: the same ring as
    ``utils.durable.buddy_holders`` (kept formula-identical so the RAM
    replica of a shard lives where its disk mirror does; duplicated
    because ``utils/durable.py`` stays unimported under
    ``ckpt_redundancy="off"``)."""
    k = max(0, min(int(k), max(0, int(world) - 1)))
    return [(int(rank) + j) % int(world) for j in range(1, k + 1)]


# ---------------------------------------------------------------------------
# Leaves: host numpy arrays, or tensors on the card
# ---------------------------------------------------------------------------


def _on_device(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array (bfloat16 as ``V2``)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()
    return np.asarray(x)


def _leaf(x):
    """A leaf kept where it lies: a tensor on the card stays a (detached,
    contiguous) tensor there; anything else becomes a host array."""
    if _on_device(x):
        return x.detach().contiguous()
    return _host(x)


def _tree_leaves(tree) -> Tuple[list, Any]:
    leaves, treedef = _tree.flatten(tree)
    return [_leaf(x) for x in leaves], treedef


def _np_dtype(x) -> np.dtype:
    return _NP_OF_TORCH[x.dtype] if isinstance(x, torch.Tensor) else x.dtype


def _shape(x) -> tuple:
    return tuple(int(d) for d in x.shape)


def _size(x) -> int:
    return int(x.numel()) if isinstance(x, torch.Tensor) else int(x.size)


def _header(x) -> bytes:
    """``"<dtype.str>:<shape>;"``, the shape as ``np.ascontiguousarray``
    gives it in the JAX package's digest: a 0-d leaf reads ``(1,)``."""
    dt = _np_dtype(x)
    shape = _shape(x) or (1,)
    return f"{_BF16_STR if dt == _BF16 else dt.str}:{shape};".encode()


def _is_delta_leaf(x) -> bool:
    """float16 / float32 / float64 with elements (numpy kind "f": the JAX
    package's bfloat16 is kind "V" and ships raw)."""
    return _np_dtype(x).kind == "f" and _size(x) > 0


def _u8(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat uint8 tensor (an empty one has none)."""
    if t.numel() == 0:
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    return t.contiguous().reshape(-1).view(torch.uint8)


def _bytes_of(x) -> np.ndarray:
    """The leaf's bytes on the host, as a flat uint8 array."""
    return np.ascontiguousarray(_host(x)).reshape(-1).view(np.uint8)


def _digest_state(leaves: List) -> str:
    """Canonical blake2b over the state's leaf bytes and shape / dtype
    headers: what the sender tags and a restore must reproduce."""
    h = hashlib.blake2b(digest_size=16)
    for x in leaves:
        h.update(_header(x))
        h.update(memoryview(_bytes_of(x)))
    return h.hexdigest()


class _Digest:
    """:func:`_digest_state` beside the caller, in two stages: the leaves'
    copies to the host on one thread (at most two leaves ahead) and the
    blake2b over them on another (hashlib lets go of the GIL on large
    updates), so the copies hide under the hashing.  Given ``leaves``, it
    digests them; else the caller feeds leaves as they are made
    (:meth:`feed`) and closes (:meth:`close`).  :meth:`result` joins; ``seconds`` is the
    digest's own time from start to the last update."""

    _END = object()

    def __init__(self, leaves: Optional[List] = None):
        import queue

        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._h = hashlib.blake2b(digest_size=16)
        self._err: Optional[BaseException] = None
        self._t0 = time.perf_counter()
        self.seconds = 0.0
        self._hasher = threading.Thread(target=self._hash, daemon=True)
        self._hasher.start()
        self._feeder = None
        if leaves is not None:
            self._feeder = threading.Thread(target=self._feed_all,
                                            args=(leaves,), daemon=True)
            self._feeder.start()

    def _feed_all(self, leaves: List) -> None:
        try:
            for x in leaves:
                self.feed(x)
        except BaseException as e:  # noqa: BLE001 — re-raised in result()
            self._err = e
        self.close()

    def feed(self, x) -> None:
        self._q.put((_header(x), _bytes_of(x)))

    def close(self) -> None:
        self._q.put(self._END)

    def _hash(self) -> None:
        while True:
            item = self._q.get()
            if item is self._END:
                break
            header, data = item
            self._h.update(header)
            self._h.update(memoryview(data))
        self.seconds = time.perf_counter() - self._t0

    def result(self) -> str:
        if self._feeder is not None:
            self._feeder.join()
        self._hasher.join()
        if self._err is not None:
            raise self._err
        return self._h.hexdigest()


# ---------------------------------------------------------------------------
# Packs: the numpy version (the JAX package's arithmetic) and the card's
# ---------------------------------------------------------------------------


def _delta_chunks_np(x: np.ndarray, b: np.ndarray, scale: np.float32,
                     q: np.ndarray) -> List[np.ndarray]:
    from .. import compress

    approx = (b.astype(np.float32)
              + compress.host_decode(q, scale)).astype(x.dtype)
    idx = np.flatnonzero((approx != x).reshape(-1)).astype(np.int64)
    vals = x.reshape(-1)[idx]
    return [q.reshape(-1).view(np.uint8),
            np.atleast_1d(np.float32(scale)).view(np.uint8),
            np.array([idx.size], np.int64).view(np.uint8),
            idx.view(np.uint8), np.ascontiguousarray(vals).view(np.uint8)]


def _pack_delta_np(new: List[np.ndarray], base: List[np.ndarray]
                   ) -> np.ndarray:
    """The JAX package's ``_pack_delta`` on host arrays: per float leaf an
    int8-quantized delta (``compress.host_encode``) plus the exact sparse
    correction that makes ``base + decode(q)`` land bit-identically on
    ``new``; other (and empty) leaves raw.  One contiguous uint8 blob."""
    from .. import compress

    chunks: List[np.ndarray] = []
    for x, b in zip(new, base):
        x = np.ascontiguousarray(x)
        if not _is_delta_leaf(x):
            chunks.append(x.reshape(-1).view(np.uint8))
            continue
        delta = x.astype(np.float32) - np.asarray(b).astype(np.float32)
        # Non-finite deltas would poison the scale; the exact correction
        # carries those elements verbatim anyway.
        delta = np.nan_to_num(delta, nan=0.0, posinf=0.0, neginf=0.0)
        q, scale = compress.host_encode(delta, "int8")
        chunks += _delta_chunks_np(x, np.asarray(b), scale, q)
    return (np.concatenate(chunks) if chunks
            else np.zeros(0, np.uint8)).copy()


def _pack_delta_device(new: List, base: List,
                       staging: Optional[Callable] = None) -> np.ndarray:
    """:func:`_pack_delta_np` with the leaves that lie on the card packed
    there: the float32 delta, ``nan_to_num``, the absolute maximum, the
    rounding, the decode (product and sum as two roundings: no FMA), the
    comparison and ``nonzero`` are torch ops on the card; the scale is
    taken on the host from the float32 maximum in float64, as
    ``compress.host_scale`` does, after one sync for all leaves' maxima.
    Only the packed chunks are copied to the host.  Byte-equal to the
    numpy pack of the same leaves."""
    from .. import compress

    t0 = time.perf_counter()
    qmax = compress._QMAX["int8"]
    base = list(base)
    dev = [k for k, x in enumerate(new)
           if isinstance(x, torch.Tensor) and _is_delta_leaf(x)]
    deltas: Dict[int, torch.Tensor] = {}
    for k in dev:
        if not isinstance(base[k], torch.Tensor):
            base[k] = _like(_host(base[k]), new[k])
        d = new[k].float() - base[k].float()
        deltas[k] = torch.nan_to_num(d, nan=0.0, posinf=0.0, neginf=0.0)
    scales: Dict[int, np.float32] = {}
    scale_t: Dict[int, torch.Tensor] = {}
    if dev:
        amax = torch.stack([deltas[k].abs().amax() for k in dev]).cpu()
        host = [compress.host_scale(float(a), "int8") for a in amax.numpy()]
        on = torch.tensor(np.array(host, np.float32),
                          device=new[dev[0]].device)
        for j, k in enumerate(dev):
            scales[k], scale_t[k] = host[j], on[j]
    parts: List = []  # np.ndarray (host) or uint8 tensors on the card
    corr: Dict[str, Dict[str, int]] = {}
    for k, (x, b) in enumerate(zip(new, base)):
        if k not in deltas:
            if isinstance(x, torch.Tensor):
                parts.append(_u8(x))
            elif _is_delta_leaf(x):
                parts.append(_pack_delta_np([x], [_host(b)]))
            else:
                parts.append(np.ascontiguousarray(x).reshape(-1)
                             .view(np.uint8))
            continue
        s = scale_t[k]
        q = torch.clamp(torch.round(deltas.pop(k) / s), -qmax,
                        qmax).to(torch.int8)
        prod = q.float() * s
        approx = (base[k].float() + prod).to(x.dtype)
        del prod
        idx = torch.nonzero((approx != x).reshape(-1)).reshape(-1)
        del approx
        vals = x.reshape(-1)[idx]
        c = corr.setdefault(str(x.dtype).replace("torch.", ""),
                            {"corrected": 0, "elements": 0})
        c["corrected"] += int(idx.numel())
        c["elements"] += int(x.numel())
        parts += [_u8(q),
                  np.atleast_1d(scales[k]).view(np.uint8),
                  np.array([idx.numel()], np.int64).view(np.uint8),
                  _u8(idx), _u8(vals)]
    _PACK_STATS["device_s"] = time.perf_counter() - t0
    _PACK_STATS["corrections"] = corr
    return _gather(parts, staging)


# The last pack on the card: ``device_s`` (its torch ops, up to the copy),
# ``d2h_s`` (the packed chunks' copy into the host blob) and
# ``corrections`` (by dtype: elements corrected, elements).
_PACK_STATS: Dict[str, Any] = {}


def _gather(parts: List, staging: Optional[Callable[[int], torch.Tensor]]
            = None) -> np.ndarray:
    """One host uint8 blob of ``parts`` in order (chunks on the card are
    copied into their place).  ``staging(n)``, when given and a part lies
    on the card, returns the host uint8 tensor of ``n`` bytes to fill (the
    replicator's pinned buffer, reused from one publish to the next)."""
    t0 = time.perf_counter()
    sizes = [int(p.numel()) if isinstance(p, torch.Tensor) else int(p.size)
             for p in parts]
    if staging is not None and any(isinstance(p, torch.Tensor)
                                   and p.device.type != "cpu"
                                   for p in parts):
        out = staging(sum(sizes))
        blob = out.numpy()
    else:
        blob = np.empty(sum(sizes), np.uint8)
        out = torch.from_numpy(blob)
    off = 0
    for p, n in zip(parts, sizes):
        if isinstance(p, torch.Tensor):
            out[off:off + n].copy_(p)
        else:
            blob[off:off + n] = p
        off += n
    _PACK_STATS["d2h_s"] = time.perf_counter() - t0
    return blob


def _pack_delta(new: List, base: List,
                staging: Optional[Callable] = None) -> np.ndarray:
    """One delta message (see :func:`_pack_delta_np`): leaves on the card
    are packed there, host leaves by numpy."""
    new = [_leaf(x) for x in new]
    base = [_leaf(b) for b in base]
    if any(_on_device(x) for x in new):
        return _pack_delta_device(new, base, staging)
    return _pack_delta_np(new, base)


def _unpack_delta(blob: np.ndarray, base: List[np.ndarray]
                  ) -> List[np.ndarray]:
    """Inverse of :func:`_pack_delta` against the same host ``base``.
    Raises (ValueError / IndexError) on a blob whose structure no longer
    parses: corrupted lengths surface as a verify failure upstream."""
    return list(_iter_unpack_delta(blob, base))


def _iter_unpack_delta(blob: np.ndarray, base: List[np.ndarray]):
    """:func:`_unpack_delta` leaf by leaf, in order (a restore digests each
    leaf as it is made).  The blob is parsed whole first (its lengths
    checked), then the leaves are decoded on _DECODE_THREADS threads."""
    from concurrent.futures import ThreadPoolExecutor

    buf = blob.view(np.uint8)
    off = 0

    def take(n: int) -> np.ndarray:
        nonlocal off
        if n < 0 or off + n > buf.size:
            raise ValueError("hotstate delta blob truncated")
        out = buf[off:off + n]
        off += n
        return out

    parts = []
    for b in base:
        b = np.ascontiguousarray(b)
        if not _is_delta_leaf(b):
            parts.append((b, take(b.nbytes), None, None, None))
            continue
        q = take(b.size).view(np.int8)
        scale = take(4).view(np.float32)[0]
        n_corr = int(take(8).view(np.int64)[0])
        if n_corr < 0 or n_corr > b.size:
            raise ValueError("hotstate delta correction count corrupt")
        idx = take(n_corr * 8).view(np.int64)
        vals = take(n_corr * b.dtype.itemsize).view(b.dtype)
        parts.append((b, q, scale, idx, vals))
    if off != buf.size:
        raise ValueError("hotstate delta blob has trailing bytes")
    with ThreadPoolExecutor(_DECODE_THREADS) as ex:
        yield from ex.map(_decode_leaf, parts)


# numpy lets go of the GIL in its array passes: a restore decodes this many
# leaves at once.
_DECODE_THREADS = 4


def _decode_leaf(part) -> np.ndarray:
    """One leaf of a delta: ``base + decode(q)`` in float32, cast back,
    then the exact corrections (or the raw bytes of a raw leaf)."""
    from .. import compress

    b, q, scale, idx, vals = part
    if scale is None:
        return q.view(b.dtype).reshape(b.shape).copy()
    approx = (b.astype(np.float32)
              + compress.host_decode(q.reshape(b.shape), scale)
              ).astype(b.dtype)
    flat = approx.reshape(-1)
    if idx.size and (idx.min() < 0 or idx.max() >= flat.size):
        raise ValueError("hotstate delta correction index corrupt")
    flat[idx] = vals
    return flat.reshape(b.shape)


def _pack_snap(leaves: List, staging: Optional[Callable] = None
               ) -> np.ndarray:
    """One full-snapshot message: every leaf's bytes, in order (leaves on
    the card copied straight into the blob)."""
    parts = []
    for x in leaves:
        x = _leaf(x)
        parts.append(_u8(x) if _on_device(x)
                     else np.ascontiguousarray(x).reshape(-1)
                     .view(np.uint8))
    return _gather(parts, staging)


class _Spec:
    """A leaf's dtype and shape on the host (a template's, for unpacking)."""

    __slots__ = ("dtype", "shape")

    def __init__(self, x):
        self.dtype = _np_dtype(x)
        self.shape = _shape(x)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize


def _unpack_snap(blob: np.ndarray, like: List) -> List[np.ndarray]:
    buf = blob.view(np.uint8)
    out, off = [], 0
    for b in like:
        b = _Spec(b)
        if off + b.nbytes > buf.size:
            raise ValueError("hotstate snapshot blob truncated")
        out.append(buf[off:off + b.nbytes].view(b.dtype)
                   .reshape(b.shape).copy())
        off += b.nbytes
    if off != buf.size:
        raise ValueError("hotstate snapshot blob has trailing bytes")
    return out


def _like(arr: np.ndarray, t):
    """A restored host leaf in the template leaf's form: a tensor on the
    template's device for a tensor, else a numpy array of its dtype."""
    if isinstance(t, torch.Tensor):
        arr = np.ascontiguousarray(arr).reshape(_shape(t))
        if arr.dtype == _BF16:
            out = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            out = torch.from_numpy(arr)
        return out.to(device=t.device, dtype=t.dtype)
    t = np.asarray(t)
    return arr.astype(t.dtype).reshape(t.shape)


class _Entry:
    """One received replica message in a buddy's RAM."""

    __slots__ = ("kind", "step", "epoch", "incarnation", "digest",
                 "blob")

    def __init__(self, kind: str, step: int, epoch: int,
                 incarnation: int, digest: str, blob: np.ndarray):
        self.kind = kind            # "snap" | "delta"
        self.step = int(step)
        self.epoch = int(epoch)
        self.incarnation = int(incarnation)
        self.digest = digest        # of the FULL state at self.step
        self.blob = blob


class Replicator:
    """The per-process hot-state store: sender mirrors (what each local
    rank last streamed, leaf-exact; a leaf on the card keeps its mirror
    there) plus the inbox of replicas received for peers (generations: a
    full snapshot and the delta chain on top of it), bounded by
    ``budget_mb``.

    The default transport is process-local delivery: in a world of one
    process (members are rank-major rows) every rank's "buddy RAM" lives
    in this one store; a multi-process gang passes ``transport`` to carry
    the packed blob and tag across hosts (one contiguous uint8 payload per
    message).  ``timings`` holds the last publish's seconds by part
    (``pack``, ``digest_wait``, ``deliver``) and the last restore's."""

    def __init__(self, world: int, *, rank: int = 0, buddies: int = 1,
                 interval: Optional[int] = None,
                 budget_mb: Optional[int] = None,
                 transport: Optional[Callable[[int, int, dict], None]]
                 = None):
        cfg = runtime.effective_config()
        self.world = int(world)
        self.rank = int(rank)
        self.buddies = max(1, int(buddies))
        self.interval = int(cfg.hotstate_interval if interval is None
                            else interval)
        self.budget_bytes = int(cfg.hotstate_budget_mb if budget_mb
                                is None else budget_mb) * (1 << 20)
        if self.interval < 1 or self.budget_bytes < 1:
            raise ValueError(
                f"hotstate interval/budget must be >= 1, got "
                f"{self.interval}/{self.budget_bytes}")
        self._transport = transport
        self._lock = threading.RLock()
        # sender side: rank -> {leaves, treedef, since_snap, force_snap}
        self._mirror: Dict[int, dict] = {}
        # receiver side: rank -> generations, each a list of _Entry
        # (generation[0] is the snapshot); oldest first.
        self._inbox: Dict[int, List[List[_Entry]]] = {}
        self.stats = {"streamed": 0, "dropped": 0, "evicted": 0}
        self.timings: Dict[str, Any] = {}
        self._pinned: Optional[torch.Tensor] = None

    def _staging(self, n: int) -> torch.Tensor:
        """The pinned host buffer a packed message on the card is copied
        into (grown, never shrunk): one message at a time, since every
        buddy copies it before :meth:`publish` returns (a ``transport``
        must consume it before it returns)."""
        if self._pinned is None or self._pinned.numel() < n:
            self._pinned = None
            self._pinned = torch.empty(n, dtype=torch.uint8,
                                       pin_memory=True)
        return self._pinned[:n]

    # -- stream (sender side) -------------------------------------------

    def publish(self, state: PyTree, step: int, *, rank: Optional[int]
                = None, epoch: int = 0, incarnation: int = 0) -> None:
        """Ship ``rank``'s state at completed step ``step`` to its
        buddies' RAM.  Epoch-fenced first (a fenced publisher raises
        ``FencedWriterError`` and lands nothing); the packed payload then
        crosses the ``hotstate.send`` fault site.  A dropped message
        forces the next publish for that rank to a full snapshot, so one
        lost delta never poisons the chain."""
        rank = self.rank if rank is None else int(rank)
        _fence_check(epoch)
        with self._lock:
            t0 = time.perf_counter()
            _PACK_STATS.clear()
            leaves, treedef = _tree_leaves(state)
            mir = self._mirror.get(rank)
            fresh = (mir is None or mir["force_snap"]
                     or mir["since_snap"] + 1 >= self.interval
                     or len(mir["leaves"]) != len(leaves))
            digest = _Digest(leaves)
            if fresh:
                blob = _pack_snap(leaves, self._staging)
                kind = "snap"
            else:
                blob = _pack_delta(leaves, mir["leaves"], self._staging)
                kind = "delta"
            t1 = time.perf_counter()
            self.timings = dict(kind=kind, pack_s=t1 - t0,
                                blob_bytes=blob.nbytes, **_PACK_STATS)
            mod = _faults_mod()
            try:
                if mod is not None:
                    mod.fire("hotstate.send", payload=blob,
                             peer=f"member:{rank}")
            except Exception as e:  # noqa: BLE001 — any injected fault
                # on the send leg: the message never left (best-effort by
                # design: a lost replica costs a rung, not a step).
                digest.result()
                self.stats["dropped"] += 1
                self._mirror[rank] = {"leaves": leaves,
                                      "treedef": treedef,
                                      "since_snap": 0,
                                      "force_snap": True}
                _record("dropped", step=step, peer=f"member:{rank}",
                        reason=type(e).__name__)
                return
            holders = _buddy_holders(rank, self.world, self.buddies)
            # The local buddies' copies of the message (their RAM) are made
            # while the digest finishes; each lands with its tag below.
            copies = {h: blob.copy() for h in holders
                      if self._transport is None or h == self.rank}
            t2 = time.perf_counter()
            entry = _Entry(kind, step, epoch, incarnation, digest.result(),
                           blob)
            t3 = time.perf_counter()
            self._mirror[rank] = {
                "leaves": [x.clone() if isinstance(x, torch.Tensor)
                           else x.copy() for x in leaves],
                "treedef": treedef,
                "since_snap": 0 if kind == "snap"
                else mir["since_snap"] + 1,
                "force_snap": False}
            self.stats["streamed"] += 1
            _record("streamed", step=step, peer=f"member:{rank}",
                    reason=kind)
            for holder in holders:
                if holder in copies:
                    self._land(rank, kind, step, copies.pop(holder),
                               digest=entry.digest, epoch=epoch,
                               incarnation=incarnation)
                else:
                    self._deliver(rank, holder, entry)
            self.timings.update(copy_s=t2 - t1, digest_s=digest.seconds,
                                digest_wait_s=t3 - t2,
                                deliver_s=time.perf_counter() - t3)

    def _deliver(self, sender: int, holder: int, entry: _Entry) -> None:
        if self._transport is not None and holder != self.rank:
            self._transport(sender, holder, {
                "kind": entry.kind, "step": entry.step,
                "epoch": entry.epoch,
                "incarnation": entry.incarnation,
                "digest": entry.digest, "blob": entry.blob})
            return
        self.receive(sender, entry.kind, entry.step, entry.blob,
                     digest=entry.digest, epoch=entry.epoch,
                     incarnation=entry.incarnation)

    # -- inbox (buddy side) ---------------------------------------------

    def receive(self, sender: int, kind: str, step: int,
                blob: np.ndarray, *, digest: str, epoch: int = 0,
                incarnation: int = 0) -> None:
        """Land one replica message in this process's RAM (the buddy half,
        also the entry point a cross-host transport calls).  The payload
        crosses the ``hotstate.recv`` fault site: a silent corruption here
        is the bit-flipped RAM buffer the digest verify must catch at
        restore time."""
        self._land(sender, kind, step, np.asarray(blob, np.uint8).copy(),
                   digest=digest, epoch=epoch, incarnation=incarnation)

    def _land(self, sender: int, kind: str, step: int, blob: np.ndarray,
              *, digest: str, epoch: int = 0, incarnation: int = 0) -> None:
        """:meth:`receive` past its copy: ``blob`` is this buddy's own."""
        entry = _Entry(kind, step, epoch, incarnation, digest, blob)
        mod = _faults_mod()
        try:
            if mod is not None:
                mod.fire("hotstate.recv", payload=entry.blob,
                         peer=f"member:{sender}")
        except Exception as e:  # noqa: BLE001 — a dropped / failed recv:
            # the buddy never saw the message; the next snapshot starts a
            # fresh generation.
            self.stats["dropped"] += 1
            _record("dropped", step=step, peer=f"member:{sender}",
                    reason=type(e).__name__)
            return
        with self._lock:
            gens = self._inbox.setdefault(int(sender), [])
            if kind == "snap" or not gens:
                if kind != "snap":
                    return  # a delta with no base is unusable
                gens.append([entry])
            else:
                gens[-1].append(entry)
            _record("received", step=step, peer=f"member:{sender}",
                    reason=kind)
            self._enforce_budget()

    def _enforce_budget(self) -> None:
        total = sum(e.blob.nbytes for gs in self._inbox.values()
                    for g in gs for e in g)
        while total > self.budget_bytes:
            # The oldest evictable generation across all peers, never a
            # peer's only (newest) one: the budget trims history depth,
            # not restorability.
            victim = None
            for sender, gens in self._inbox.items():
                if len(gens) > 1 and (victim is None
                                      or gens[0][0].step
                                      < victim[1][0][0].step):
                    victim = (sender, gens)
            if victim is None:
                break
            gen = victim[1].pop(0)
            total -= sum(e.blob.nbytes for e in gen)
            self.stats["evicted"] += 1
            _record("evicted", step=gen[0].step,
                    peer=f"member:{victim[0]}")

    def inbox_bytes(self) -> int:
        """Bytes of every replica held in this process's RAM."""
        with self._lock:
            return sum(e.blob.nbytes for gs in self._inbox.values()
                       for g in gs for e in g)

    # -- restore (the RAM rung) -----------------------------------------

    def latest_step(self, rank: Optional[int] = None) -> int:
        """Newest replicated step for ``rank`` (unverified), 0 if none."""
        rank = self.rank if rank is None else int(rank)
        with self._lock:
            gens = self._inbox.get(rank, [])
            return max((e.step for g in gens for e in g), default=0)

    def restore(self, template: PyTree, *, rank: Optional[int] = None,
                step: Optional[int] = None
                ) -> Optional[Tuple[PyTree, int]]:
        """Reconstruct ``rank``'s newest digest-verified state from the RAM
        replicas: walk candidate target entries newest first (each rebuilt
        from its generation's snapshot through its delta chain, on the
        host), digest-verify against the sender's tag, and return the first
        survivor as ``(state, step)``, its leaves in the template's form
        (a tensor leaf on the template leaf's device).  ``step`` pins the
        target to one exact step (the multi-process agreement path).  A
        failed candidate counts ``tm_hotstate_verify_failed_total`` and the
        walk goes on; None when nothing survives (the caller falls to the
        disk rung)."""
        t0 = time.perf_counter()
        rank = self.rank if rank is None else int(rank)
        t_leaves, treedef = _tree.flatten(template)
        specs = [_Spec(_leaf(t)) for t in t_leaves]
        with self._lock:
            gens = [list(g) for g in self._inbox.get(rank, [])]
        for gen in reversed(gens):
            snap = None  # the generation's snapshot, unpacked once
            for cut in range(len(gen), 0, -1):
                target = gen[cut - 1]
                if step is not None and target.step != int(step):
                    continue
                digest = _Digest()  # fed the target's leaves as made
                try:
                    if snap is None:
                        snap = _unpack_snap(gen[0].blob, specs)
                    leaves = snap
                    chain = gen[1:cut]
                    for e in chain[:-1]:
                        leaves = _unpack_delta(e.blob, leaves)
                    made = (_iter_unpack_delta(chain[-1].blob, leaves)
                            if chain else iter(leaves))
                    leaves = []
                    for leaf in made:
                        digest.feed(leaf)
                        leaves.append(leaf)
                except Exception as e:  # noqa: BLE001 — corrupt blob
                    digest.close()
                    digest.result()
                    _record("verify_failed", step=target.step,
                            peer=f"member:{rank}",
                            reason=type(e).__name__)
                    continue
                digest.close()
                if digest.result() != target.digest:
                    _record("verify_failed", step=target.step,
                            peer=f"member:{rank}", reason="digest")
                    continue
                state = _tree.unflatten(
                    treedef, [_like(l, t) for l, t in zip(leaves,
                                                          t_leaves)])
                self.timings["restore_s"] = time.perf_counter() - t0
                return state, target.step
        self.timings["restore_s"] = time.perf_counter() - t0
        return None

    # -- membership bookkeeping -----------------------------------------

    def adopt(self, rank: int, state: PyTree, step: int, *,
              epoch: int = 0, incarnation: int = 0) -> None:
        """Pre-seed ``rank``'s slot with a verified full state (the
        migration hand-off: the spare's RAM is primed before it is
        admitted, so it starts streaming deltas at once)."""
        leaves, _ = _tree_leaves(state)
        digest = _Digest(leaves)
        blob = _pack_snap(leaves)
        entry = _Entry("snap", step, epoch, incarnation, digest.result(),
                       blob)
        with self._lock:
            self._inbox.setdefault(int(rank), []).append([entry])
            self._enforce_budget()

    def drop(self, ranks) -> None:
        """Forget a retired or dead rank's sender mirror and replicas,
        once its state has been consumed (a migration's retire, or a
        shrink whose recovery settled)."""
        if isinstance(ranks, int):
            ranks = [ranks]
        with self._lock:
            for r in ranks:
                self._mirror.pop(int(r), None)
                self._inbox.pop(int(r), None)

    def note_shrink(self, ranks, step: int) -> None:
        """Membership evidence from the elastic driver: the dead ranks
        stop streaming (their mirrors go), but their replicas stay: they
        are what the RAM rung restores from."""
        if isinstance(ranks, int):
            ranks = [ranks]
        with self._lock:
            for r in ranks:
                self._mirror.pop(int(r), None)
        for r in ranks:
            _record("peer_lost", step=step, peer=f"member:{int(r)}")


# ---------------------------------------------------------------------------
# Module-level driver surface (what restart and elastic reach through
# sys.modules).
# ---------------------------------------------------------------------------

_active_rep: Optional[Replicator] = None


def enable(world: int, *, rank: int = 0, buddies: int = 1,
           interval: Optional[int] = None,
           budget_mb: Optional[int] = None,
           transport: Optional[Callable] = None) -> Replicator:
    """Arm the hot-state tier for this process (consent-gated on
    ``Config.hotstate``).  Returns the active :class:`Replicator`."""
    global _active_rep
    _require_on()
    _active_rep = Replicator(world, rank=rank, buddies=buddies,
                             interval=interval, budget_mb=budget_mb,
                             transport=transport)
    return _active_rep


def disable() -> None:
    global _active_rep
    _active_rep = None


def active() -> bool:
    return _active_rep is not None


def replicator() -> Replicator:
    if _active_rep is None:
        raise RuntimeError("hotstate is not enabled (hotstate.enable)")
    return _active_rep


def offer_restore(template: PyTree, *, rank: Optional[int] = None,
                  min_step: int = 0, step: Optional[int] = None
                  ) -> Optional[Tuple[PyTree, int]]:
    """The RAM rung as ``restart.recover`` consults it (through
    ``sys.modules``): the newest digest-verified replica for ``rank``
    (default this process's own) at or above ``min_step`` (the newest
    disk step: a RAM copy older than the disk tier is stale and the disk
    rung wins), or None with ``tm_hotstate_fallback_disk_total`` counted.
    A hit counts ``tm_hotstate_restored_total``."""
    rep = _active_rep
    if rep is None:
        return None
    who = f"member:{rep.rank if rank is None else rank}"
    got = rep.restore(template, rank=rank, step=step)
    if got is None or got[1] < int(min_step):
        _record("fallback_disk",
                step=0 if got is None else got[1], peer=who,
                reason="missing" if got is None else "stale")
        return None
    _record("restored", step=got[1], peer=who)
    return got


def migrate(source: int, spare: int, template: PyTree, *,
            admit: Optional[Callable[[PyTree, int], Any]] = None,
            retire: Optional[Callable[[int], Any]] = None,
            epoch: int = 0) -> Tuple[PyTree, int]:
    """Drain ``source`` onto ``spare`` at a step boundary with zero
    checkpoint rollback (the reverse of ``elastic.admit``): reconstruct
    the source's newest verified state from the stream, pre-seed the
    spare's RAM with it (:meth:`Replicator.adopt`), hand it to
    ``admit(state, step)``, then retire the source (``retire(source)``
    and :meth:`Replicator.drop`).  The drain is lease-visible: watchdog
    state ``migrating`` with ``rank S -> rank P`` detail.  Returns
    ``(state, step)``: the step the spare resumes at (the source's last
    completed step)."""
    _require_on()
    rep = replicator()
    wd = sys.modules.get(_PKG + ".watchdog")
    if wd is not None and wd.active():
        wd.set_state("migrating",
                     detail=f"rank {int(source)} -> rank {int(spare)}")
    try:
        got = rep.restore(template, rank=int(source))
        if got is None:
            _record("fallback_disk", peer=f"member:{int(source)}")
            raise HotStateMiss(
                f"no verified RAM replica for rank {source} — migrate "
                f"needs a live stream (fall back to checkpoint "
                f"admission)")
        state, step = got
        rep.adopt(int(spare), state, step, epoch=epoch)
        if admit is not None:
            admit(state, step)
        if retire is not None:
            retire(int(source))
        rep.drop(int(source))
        _record("migrated", step=step,
                peer=f"member:{int(source)}->member:{int(spare)}")
        return state, step
    finally:
        if wd is not None and wd.active():
            wd.set_state("running")
