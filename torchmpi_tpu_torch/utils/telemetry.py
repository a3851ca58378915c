"""The sys.modules-gated obs dispatch shim.

The PyTorch counterpart of ``torchmpi_tpu/utils/telemetry.py``.  The
off-by-default layers (the fault policy, the watchdog, the serving
fault half: ``faults/``, ``watchdog.py``) report telemetry through
:mod:`torchmpi_tpu_torch.obs` *without importing it*: a session that arms
one of them but not obs must never pull the telemetry layer into the
process.  This is the ONE implementation of that contract: look the
module up in ``sys.modules``, check ``active()``, dispatch, and swallow
everything — telemetry never fails a step.  Dependency-free on purpose.
"""

from __future__ import annotations

import sys

_OBS = __name__.rsplit(".", 2)[0] + ".obs"


def emit(method: str, *args, **kwargs) -> None:
    """Call ``torchmpi_tpu_torch.obs.<method>(*args, **kwargs)`` iff obs
    is imported AND active; no-op (and exception-proof) otherwise."""
    mod = sys.modules.get(_OBS)
    try:
        if mod is not None and mod.active():
            getattr(mod, method)(*args, **kwargs)
    except Exception:  # noqa: BLE001 — telemetry never fails a step
        pass


def flight_tail(n: int = 8) -> list:
    """The last ``n`` flight-recorder events, when obs is active — the
    evidence a typed hang/timeout error ships with, so the exception
    that kills a step arrives with what ``tool blame`` would otherwise
    dig out of a post-mortem dump (``collectives.PeerTimeoutError``);
    same sys.modules gate as :func:`emit`."""
    mod = sys.modules.get(_OBS)
    try:
        if mod is not None and mod.active():
            return mod.recorder().to_records(best_effort=True)[-n:]
    except Exception:  # noqa: BLE001 — evidence must not mask the error
        pass
    return []
