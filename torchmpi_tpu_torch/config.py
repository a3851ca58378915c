"""Runtime configuration for torchmpi_tpu_torch.

The PyTorch counterpart of ``torchmpi_tpu/config.py``: one dataclass plus
``TORCHMPI_TPU_*`` environment overrides, holding only the knobs the ported
modules read.  Field names, defaults and environment variable names are the
JAX package's, so one environment configures both.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v is not None else default


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclasses.dataclass
class Config:
    """All runtime knobs of the port.

    - ``backend``: default collective route.  ``"xla"`` is the stock route,
      which here is the process group's own backend (NCCL on the card, gloo
      on the CPU); ``"pallas"`` names the hand-written ring kernels
      (``ops/ring.py``, see selector.py for where they run).
    - ``flash_prescale``: fold the attention scale into q once at the kernel
      boundary; the backward puts it back on dq by the chain rule.
    - ``fuse_max_bytes``: upper bound on one fused gradient bucket; leaves
      group by dtype and each group splits into ceil(bytes / bound) buckets,
      one collective each.  0 keeps one bucket per dtype group.
    - ``gradsync_average``: gradient sync averages (True) or sums.
    - ``gradsync_compress``: on-the-wire gradient compression of the
      gradient sync (``synchronize_gradients``, so ``data_parallel_step``)
      and of ZeRO's reduce-scatter leg: None (off) or ``"bf16"``.
    - ``chunk_bytes``: subchunk size of the chunked ring allreduce: when one
      rank's per-ring-chunk payload (its bytes / n) exceeds it, the ring
      streams subchunks of about this size through two comm slots.
    - ``custom_min_bytes``: tensors smaller than this stay on the stock
      route even when the config's backend is a custom one (an explicit
      per-call backend bypasses the cutover).
    - ``pallas_bidirectional``: the ring allreduce splits a tensor in two
      halves that rotate in opposite directions.
    - ``gradsync_overlap`` ("off" | "auto"), ``analysis`` and ``obs``
      ("off" | ...): the JAX package's backprop-overlapped gradient sync,
      static collective analysis and telemetry.  Their modules are not
      ported (ROADMAP queue A, items 3 b, 11 and 10); the recipes
      refuse any value but "off" by the item's name.
    """

    backend: str = "xla"
    flash_prescale: bool = False
    fuse_max_bytes: int = 32 * 1024 * 1024
    gradsync_average: bool = True
    gradsync_compress: Optional[str] = None
    chunk_bytes: int = 4 * 1024 * 1024
    custom_min_bytes: int = 64 * 1024
    pallas_bidirectional: bool = False
    gradsync_overlap: str = "off"
    analysis: str = "off"
    obs: str = "off"

    @staticmethod
    def from_env(**overrides) -> "Config":
        """Build a Config from the environment (TORCHMPI_TPU_BACKEND,
        TORCHMPI_TPU_FLASH_PRESCALE, TORCHMPI_TPU_FUSE_MAX_BYTES,
        TORCHMPI_TPU_GRADSYNC_AVERAGE, TORCHMPI_TPU_GRADSYNC_COMPRESS,
        TORCHMPI_TPU_CHUNK_BYTES, TORCHMPI_TPU_CUSTOM_MIN_BYTES,
        TORCHMPI_TPU_GRADSYNC_OVERLAP, TORCHMPI_TPU_ANALYSIS,
        TORCHMPI_TPU_OBS; ``pallas_bidirectional`` has none), then apply
        ``overrides``."""
        cfg = Config(
            backend=_env_str("TORCHMPI_TPU_BACKEND", "xla"),
            flash_prescale=_env_bool("TORCHMPI_TPU_FLASH_PRESCALE", False),
            fuse_max_bytes=_env_int("TORCHMPI_TPU_FUSE_MAX_BYTES",
                                    32 * 1024 * 1024),
            gradsync_average=_env_bool("TORCHMPI_TPU_GRADSYNC_AVERAGE", True),
            gradsync_compress=(
                os.environ.get("TORCHMPI_TPU_GRADSYNC_COMPRESS") or None),
            chunk_bytes=_env_int("TORCHMPI_TPU_CHUNK_BYTES", 4 * 1024 * 1024),
            custom_min_bytes=_env_int("TORCHMPI_TPU_CUSTOM_MIN_BYTES",
                                      64 * 1024),
            gradsync_overlap=_env_str("TORCHMPI_TPU_GRADSYNC_OVERLAP",
                                      "off"),
            analysis=_env_str("TORCHMPI_TPU_ANALYSIS", "off"),
            obs=_env_str("TORCHMPI_TPU_OBS", "off"),
        )
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown config field {k!r}")
            setattr(cfg, k, v)
        return cfg


def wire_compress(value, *, site: str) -> Optional[str]:
    """A wire-compression knob made canonical (the JAX package's
    ``gradsync._wire_compress`` -> ``compress.validate_wire`` with
    ``allowed=("bf16",)``): None, "none", "off" or "" mean uncompressed and
    give None; otherwise the value must name "bf16" (any case) or this
    raises."""
    if value is None:
        return None
    v = str(value).strip().lower()
    if v in ("none", "off", ""):
        return None
    if v != "bf16":
        raise ValueError(f"{site}: unknown compression {value!r} "
                         f"(allowed: bf16 or none)")
    return v
