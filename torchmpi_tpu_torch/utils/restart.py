"""Checkpoint-restart training loop (the JAX package's
``utils/restart.py``; docs/CHECKPOINT_TORCH.md).

Recovery is checkpoint-restart: run a step function with periodic
checkpoints and, on a failure, restore the newest checkpoint every
participant can agree on and replay the steps since it (exact for
deterministic steps).  :func:`run_with_restarts` is the loop,
:func:`recover` the restore: one process walks back past unreadable
steps; several run an agreement loop in which every branch is decided
from globally agreed values (``checkpoint.agree_min_step``).

A ``PeerTimeoutError`` (``collectives.PeerTimeoutError``, the one class
of the port) or the watchdog's ``CollectiveHangError`` (a stalled wait the
watchdog broke) takes the ``on_peer_timeout`` path of the same restore.
Both are recognized by type through ``sys.modules``: this module imports
neither the fault layer nor the watchdog, nor the telemetry it reports to
(``obs.record_restart``), nor the hot-state tier it consults first
(``torchmpi_tpu_torch.hotstate``, docs/HOTSTATE_TORCH.md: the RAM rung,
one lookup that finds nothing unless the user enabled the tier).  The elastic gang passes ``recover`` its
survivors-only ``participants`` and ``agree`` (``elastic.py``).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from . import checkpoint, telemetry

PyTree = Any
_PKG = __name__.rsplit(".", 2)[0]


def _health_path(directory: str) -> str:
    return os.path.join(directory, f"health_p{checkpoint._proc()}.json")


def _save_health(directory: str) -> None:
    """Snapshot the armed fault layer's per-peer health ledger next to the
    checkpoints, so peer health survives a process-level restart.
    Best-effort: telemetry-grade state never fails a save."""
    mod = sys.modules.get(_PKG + ".faults")
    if mod is None or not mod.active():
        return
    try:
        path = _health_path(directory)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(mod.ledger().to_dict(), f, sort_keys=True)
        os.replace(tmp, path)
    except Exception:  # noqa: BLE001 — evidence, not correctness
        pass


def _load_health(directory: str) -> None:
    """Rehydrate the armed ledger from the last :func:`_save_health`
    snapshot, if one exists."""
    mod = sys.modules.get(_PKG + ".faults")
    if mod is None or not mod.active():
        return
    try:
        path = _health_path(directory)
        if os.path.exists(path):
            with open(path) as f:
                mod.ledger().restore(json.load(f))
    except Exception:  # noqa: BLE001 — a torn snapshot is just absent
        pass


def _is_peer_timeout(e: BaseException) -> bool:
    """Is ``e`` a ``PeerTimeoutError`` or the watchdog's
    ``CollectiveHangError``?  Checked through ``sys.modules``: a layer
    never imported has raised nothing."""
    col = sys.modules.get(_PKG + ".collectives")
    if col is not None and isinstance(e, col.PeerTimeoutError):
        return True
    wd = sys.modules.get(_PKG + ".watchdog")
    return wd is not None and isinstance(e, wd.CollectiveHangError)


def _obs_record(event: str, step: int) -> None:
    """A recovery decision through obs when it is active."""
    telemetry.emit("record_restart", event, step)


def _ram_rung(template: PyTree, *, min_step: int = 0,
              step: Optional[int] = None
              ) -> Optional[Tuple[PyTree, int]]:
    """The hot-state RAM rung (docs/HOTSTATE_TORCH.md), consulted first
    when the user armed it: one ``sys.modules`` lookup, so a session that
    never enabled ``hotstate`` never imports it.  Returns a
    digest-verified ``(state, step)`` or None (stale, missing or corrupt:
    the tier counts its own ``tm_hotstate_fallback_disk_total`` and the
    ladder steps down to the disk buddies); a broken tier never blocks a
    disk recovery."""
    mod = sys.modules.get(_PKG + ".hotstate")
    if mod is None or not mod.active():
        return None
    try:
        return mod.offer_restore(template, min_step=min_step, step=step)
    except Exception:  # noqa: BLE001 — a rung, not a requirement
        return None


def _fsync_verify(directory: str, step: int) -> None:
    """Durability check on the step recovery settled on: the local npz
    must still be readable after the restore that parsed it, and the
    directory is fsync'd so the rename that made the file is durable
    before training resumes on it (best-effort where directories cannot
    be fsync'd)."""
    path = os.path.join(directory,
                        f"ckpt_{step}_p{checkpoint._proc()}.npz")
    with open(path, "rb") as f:
        if not f.read(1):
            raise OSError(f"checkpoint {path} is empty after restore")
    try:
        fd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def attach_ef_residuals(state: Dict[str, Any], *,
                        params_key: str = "params", axis_names=None,
                        n: Optional[int] = None,
                        n_buckets: Optional[int] = None, device=None,
                        key: str = "ef_residuals") -> Dict[str, Any]:
    """A new state dict with zeroed dcn error-feedback residuals under
    ``key`` (``parallel.gradsync.init_dcn_residuals`` of
    ``state[params_key]``, one rank's parameters; ``n`` for a rank-major
    stack of n ranks), so they ride every checkpoint of
    :func:`run_with_restarts` as optimizer state does: dropping them on a
    restore would apply a step's accumulated error again on every replay.
    The step function threads ``state[key]`` through the sync."""
    from .. import _tree
    from ..parallel import gradsync

    if params_key not in state:
        raise KeyError(
            f"state has no {params_key!r} entry to derive the residual "
            f"bucket layout from (keys: {sorted(state)})")
    if key in state:
        raise ValueError(f"state already has a {key!r} entry")
    out = dict(state)
    params = state[params_key]
    out[key] = gradsync.init_dcn_residuals(
        params if isinstance(params, torch.nn.Module)
        else _tree.leaves(params), axis_names, n=n, n_buckets=n_buckets,
        device=device)
    return out


def recover(init_fn: Callable[[], PyTree], directory: str,
            template: PyTree, *, participants: Optional[int] = None,
            agree: Optional[Callable[[int], int]] = None
            ) -> Tuple[PyTree, int]:
    """Restore the newest checkpoint all participants agree on; returns
    ``(state, next_step)``.

    One participant: the newest restorable step, walking back past ones
    that fail (each rejection recorded with its reason).  Several (every
    process calls this together): propose the newest local step under the
    ceiling, agree on the minimum, all restore exactly it, agree on a
    success flag; a failure anywhere lowers the ceiling for everyone, down
    to a collective fresh start when no common step exists.
    ``participants`` defaults to the process count and ``agree`` to
    ``checkpoint.agree_min_step``.  The settled step is fsync-verified,
    pinned against retention and logged (obs ``record_restart``)."""
    if participants is None:
        participants = checkpoint._nproc()
    if agree is None:
        agree = checkpoint.agree_min_step

    def settled(state, step, source="disk"):
        if step > 0 and source == "disk":
            _fsync_verify(directory, step)
        checkpoint.protect_step(directory, step)
        _obs_record("recovered" if step > 0 else "fresh_start", step)
        return state, step

    steps_avail = [s for s in checkpoint.available_steps(directory) if s > 0]
    if participants <= 1:
        ram = _ram_rung(template,
                        min_step=steps_avail[-1] if steps_avail else 1)
        if ram is not None:
            return settled(ram[0], ram[1], source="ram")
        for step in reversed(steps_avail):
            try:
                return settled(checkpoint.restore(directory, template,
                                                  step=step), step)
            except Exception as e:  # noqa: BLE001 — the next older step,
                # with the reason this one was rejected on record
                checkpoint._record_walkback(step, e)
        if steps_avail:
            ram = _ram_rung(template)
            if ram is not None:
                return settled(ram[0], ram[1], source="ram")
        return settled(init_fn(), 0)
    hs = sys.modules.get(_PKG + ".hotstate")
    ram_step = 0
    if hs is not None and hs.active():
        try:
            ram_step = hs.replicator().latest_step()
        except Exception:  # noqa: BLE001 — a rung, not a requirement
            ram_step = 0
    ceiling = None
    while True:
        cand = next((s for s in reversed(steps_avail)
                     if ceiling is None or s <= ceiling), 0)
        if ram_step and (ceiling is None or ram_step <= ceiling):
            cand = max(cand, ram_step)
        agreed = agree(cand)
        if agreed <= 0:
            return settled(init_fn(), 0)  # collectively: nothing common
        state, ok, source = None, 1, "disk"
        ram = (_ram_rung(template, step=agreed)
               if ram_step and agreed <= ram_step else None)
        if ram is not None:
            state, source = ram[0], "ram"
        else:
            try:
                state = checkpoint.restore(directory, template, step=agreed)
            except Exception as e:  # noqa: BLE001 — resolved collectively
                checkpoint._record_walkback(agreed, e)
                ok = 0
        if agree(ok):
            return settled(state, agreed, source=source)
        ceiling = agreed - 1  # someone failed: walk back together
        ram_step = 0  # a failed round demotes the RAM rung


def run_with_restarts(
    init_fn: Callable[[], PyTree],
    step_fn: Callable[[PyTree, int], PyTree],
    *,
    steps: int,
    directory: str,
    save_every: int = 10,
    max_restarts: int = 3,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
    on_peer_timeout: Optional[Callable[[int, BaseException], None]] = None,
) -> Tuple[PyTree, Dict[str, int]]:
    """Run ``steps`` calls of ``step_fn(state, i) -> state`` with
    checkpoint-restart recovery.

    ``init_fn()`` builds the initial state (and the restore template).  A
    checkpoint is written every ``save_every`` completed steps and at the
    end.  If ``step_fn`` raises, the newest agreed checkpoint is restored
    and training resumes from the step after it, up to ``max_restarts``
    times, after which the last exception propagates.  A checkpoint
    already in ``directory`` is picked up on entry, so running the whole
    process again after a fatal crash resumes too.  A ``PeerTimeoutError``
    or ``CollectiveHangError`` takes the same restore but notifies
    ``on_peer_timeout`` instead of ``on_restart``.

    Returns ``(final_state, info)``, ``info = {"restarts": r,
    "restarts_used": r, "steps_run": n, "recovered_step": s}``:
    ``steps_run`` counts executed step calls, replays included;
    ``recovered_step`` is the step the last recovery settled on (0 for
    none, or a fresh start)."""
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    template = init_fn()
    _load_health(directory)

    state, i = recover(init_fn, directory, template)
    recovered_step = i
    restarts = 0
    steps_run = 0
    while i < steps:
        try:
            state = step_fn(state, i)
            steps_run += 1
            i += 1
            if i % save_every == 0 or i == steps:
                checkpoint.save(directory, state, step=i)
                _save_health(directory)
            continue
        except KeyboardInterrupt:
            raise
        except BaseException as e:  # noqa: BLE001 — the restart loop is
            # the handler: restore and replay, or re-raise past the budget
            restarts += 1
            # The failure is health evidence: snapshot before recovery.
            _save_health(directory)
            if _is_peer_timeout(e):
                _obs_record("peer_timeout", i)
                if on_peer_timeout is not None:
                    on_peer_timeout(restarts, e)
            elif on_restart is not None:
                on_restart(restarts, e)
            if restarts > max_restarts:
                raise
        # Restored outside the handler: the exception, its traceback and
        # what their frames hold (the host buffers of a broken staged
        # wait, the failed step's state) are released first.
        state = None
        state, i = recover(init_fn, directory, template)
        recovered_step = i
    return state, {"restarts": restarts, "restarts_used": restarts,
                   "steps_run": steps_run, "recovered_step": recovered_step}
