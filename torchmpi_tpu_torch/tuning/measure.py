"""Shared measurement discipline for backend selection.

The PyTorch counterpart of ``torchmpi_tpu/tuning/measure.py`` (:24-70):

- every candidate is timed over :data:`ROUNDS` fenced rounds via
  ``utils/metrics.timed`` (one warm call first, so a ring kernel's build
  is never timed) and scored by the MEDIAN round;
- the per-candidate jitter (half the inter-quartile range) is kept with
  every measurement;
- a NOISE GATE keeps the default candidate unless a challenger beats it
  by more than the combined jitter of the two: the anti-flap rule that
  makes re-runs agree with themselves.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..utils import metrics

# Fenced rounds a candidate.  The JAX package's 3 leave the jitter at half
# the range of three single-call rounds: 0.020-0.044 ms for the ring at
# the ResNet-50 BatchNorm statistics' size (b17) in chip_smoke.py's
# auto_dp on an H100 80GB HBM3 at 700 W, above the gap between the
# candidates.  From four rounds on the jitter is half the inter-quartile
# range, which one slow round does not move.
ROUNDS = 9


def measure(step, iters: int = 1, rounds: int = ROUNDS,
            fence=metrics.fence) -> metrics.TimedResult:
    """Time ``step`` (one warm call + ``rounds`` fenced rounds of ``iters``
    calls); returns the structured TimedResult."""
    return metrics.timed(step, max(1, iters), fence=fence,
                         rounds=max(1, rounds))


def noise_gate(cands: Dict, default_key,
               ) -> Tuple[Optional[object], dict]:
    """Noise-gated argmin over ``cands`` ({key: TimedResult}).

    Returns ``(chosen_key, evidence)``.  The default wins unless some
    candidate's median beats the default's by MORE than the pair's
    combined jitter.  With no successful measurements returns
    ``(default_key, ...)``; with the default candidate missing, a plain
    argmin over what did measure.
    """
    if not cands:
        return default_key, {"note": "no successful measurements"}
    if default_key not in cands:
        k = min(cands, key=lambda k: cands[k].median)
        return k, {"note": "default candidate failed; plain argmin",
                   "chosen_ms": round(cands[k].median * 1e3, 3)}
    d = cands[default_key]
    k_min = min(cands, key=lambda k: cands[k].median)
    m = cands[k_min]
    delta = d.median - m.median
    needed = max(d.jitter + m.jitter, 0.0)
    chosen = k_min if (k_min != default_key and delta > needed) \
        else default_key
    return chosen, {
        "default": str(default_key),
        "default_ms": round(d.median * 1e3, 3),
        "fastest": str(k_min),
        "fastest_ms": round(m.median * 1e3, 3),
        "delta_ms": round(delta * 1e3, 3),
        "noise_floor_ms": round(needed * 1e3, 3),
        "gated_to_default": chosen == default_key and k_min != default_key,
    }

