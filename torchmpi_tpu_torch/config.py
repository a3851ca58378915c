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


PS_TIMEOUT_S = 30.0


def ps_timeout_s(value: Optional[float] = None) -> float:
    """The parameter server's socket timeout in seconds (0 disables): the
    one policy behind ``Config.ps_timeout_s``.  A ``value`` away from the
    default wins; at the default, or None, the environment decides:
    ``TORCHMPI_TPU_PS_TIMEOUT`` in seconds, else the legacy
    ``TORCHMPI_TPU_PS_TIMEOUT_MS`` in milliseconds, else the default.
    Negative raises, as in the JAX package's ``init``."""
    if value is None or value == PS_TIMEOUT_S:
        if os.environ.get("TORCHMPI_TPU_PS_TIMEOUT"):
            value = float(os.environ["TORCHMPI_TPU_PS_TIMEOUT"])
        elif os.environ.get("TORCHMPI_TPU_PS_TIMEOUT_MS"):
            value = float(os.environ["TORCHMPI_TPU_PS_TIMEOUT_MS"]) / 1000.0
        else:
            value = PS_TIMEOUT_S
    value = float(value)
    if value < 0:
        raise ValueError(f"config.ps_timeout_s must be >= 0 (0 disables), "
                         f"got {value}")
    return value


@dataclasses.dataclass
class Config:
    """All runtime knobs of the port.

    - ``backend``: default collective route.  ``"xla"`` is the stock route,
      which here is the process group's own backend (NCCL on the card, gloo
      on the CPU); ``"pallas"`` names the hand-written ring kernels
      (``ops/ring.py``, see selector.py for where they run);
      ``"hierarchical"`` the two-level verbs; ``"auto"`` the measured
      choice of the tuning plans (``tuning/``): per (op, size bucket,
      grid, platform), measured on the first eager call of a key and
      persisted.
    - ``tuning_plan_path``: the plan file ``"auto"`` reads and extends;
      None resolves to ``TORCHMPI_TPU_TUNING_PLAN``, then
      ``<checkout>/.tuning_plans_torch/plans.json``.  A corrupt or
      mismatched file degrades silently to static selection.
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
    - ``staged``: the rank-major verbs take the host-staged path (device
      -> pinned host -> reduction or routing on the host -> device), the
      reference's staged collectives; off (direct) by default.
    - ``gradsync_buckets``: buckets of the bucketed gradient allreduce;
      1 (the default) rides the fused collectives (``fuse_max_bytes``),
      more cut each dtype group by its byte share (``FusedSpec``'s
      ``n_buckets``).
    - ``gradsync_barrier``: the JAX package's optimization-barrier chain
      between buckets.  Each bucket here is its own launch, issued in
      order, which is what the chain buys against XLA's combiner, so both
      values give the same bits.
    - ``gradsync_overlap`` ("off" | "auto"): "auto" makes the recipes
      compute gradients through ``gradsync.make_overlapped_grad_fn``,
      each bucket's allreduce fired from the backward as its gradients
      arrive.
    - ``gradsync_overlap_bytes``: the byte bound of one overlap bucket; 0
      takes ``fuse_max_bytes`` rounded down to a power of two.
    - ``dcn_size`` / ``ici_size``: the two-level world's outer (inter-node,
      "dcn") and inner (intra-node, "ici") sizes (runtime.py says how they
      factor the process world and a rank-major stack); None = auto.
    - ``hierarchical``: route the verbs that have one through the
      ``"hierarchical"`` backend (``parallel/hierarchical.py``) whatever
      ``backend`` says: reduce-scatter over ici, allreduce over dcn,
      all-gather over ici (the reference's torchmpi_set_hierarchical_
      collectives).
    - ``dcn_chunk_bytes``: chunk bound of the hierarchical allreduce: when
      one rank's ici-scattered shard exceeds it, the tensor is cut into up
      to 16 chunks whose dcn legs pipeline behind the next chunk's ici
      leg; 0 keeps one chunk.  Bitwise the same result either way.
    - ``dcn_compress`` ("off" | "bf16" | "int8" | "fp8"): the wire codec of
      the dcn leg (``compress.py``); "off" never imports the codec module.
    - ``dcn_compress_min_bytes``: a dcn leg (the ici-scattered shard)
      below this crosses uncompressed.
    - ``ps_timeout_s``: the socket timeout armed on every parameter-server
      client connection, in seconds: a wedged shard server surfaces as a
      failed future within this bound instead of hanging ``wait()``; 0
      disables.  Resolved by :func:`ps_timeout_s`.
    - ``analysis`` and ``obs`` ("off" | ...): the JAX package's static
      collective analysis and telemetry.  Their modules are not ported
      (ROADMAP queue A, items 11 and 10); the recipes refuse any value
      but "off" by the item's name.
    """

    backend: str = "xla"
    tuning_plan_path: Optional[str] = None
    flash_prescale: bool = False
    fuse_max_bytes: int = 32 * 1024 * 1024
    gradsync_average: bool = True
    gradsync_compress: Optional[str] = None
    chunk_bytes: int = 4 * 1024 * 1024
    custom_min_bytes: int = 64 * 1024
    pallas_bidirectional: bool = False
    staged: bool = False
    gradsync_buckets: int = 1
    gradsync_barrier: bool = False
    gradsync_overlap: str = "off"
    gradsync_overlap_bytes: int = 0
    dcn_size: Optional[int] = None
    ici_size: Optional[int] = None
    hierarchical: bool = False
    dcn_chunk_bytes: int = 4 * 1024 * 1024
    dcn_compress: str = "off"
    dcn_compress_min_bytes: int = 64 * 1024
    ps_timeout_s: float = PS_TIMEOUT_S
    analysis: str = "off"
    obs: str = "off"

    @staticmethod
    def from_env(**overrides) -> "Config":
        """Build a Config from the environment (TORCHMPI_TPU_BACKEND,
        TORCHMPI_TPU_TUNING_PLAN,
        TORCHMPI_TPU_FLASH_PRESCALE, TORCHMPI_TPU_FUSE_MAX_BYTES,
        TORCHMPI_TPU_GRADSYNC_AVERAGE, TORCHMPI_TPU_GRADSYNC_COMPRESS,
        TORCHMPI_TPU_CHUNK_BYTES, TORCHMPI_TPU_CUSTOM_MIN_BYTES,
        TORCHMPI_TPU_STAGED, TORCHMPI_TPU_GRADSYNC_BUCKETS,
        TORCHMPI_TPU_GRADSYNC_OVERLAP, TORCHMPI_TPU_GRADSYNC_OVERLAP_BYTES,
        TORCHMPI_TPU_GRADSYNC_BARRIER, TORCHMPI_TPU_DCN_SIZE,
        TORCHMPI_TPU_ICI_SIZE, TORCHMPI_TPU_HIERARCHICAL,
        TORCHMPI_TPU_DCN_CHUNK_BYTES, TORCHMPI_TPU_DCN_COMPRESS,
        TORCHMPI_TPU_DCN_COMPRESS_MIN_BYTES, TORCHMPI_TPU_PS_TIMEOUT (see
        :func:`ps_timeout_s`), TORCHMPI_TPU_ANALYSIS, TORCHMPI_TPU_OBS;
        ``pallas_bidirectional`` has none), then apply ``overrides``."""
        cfg = Config(
            backend=_env_str("TORCHMPI_TPU_BACKEND", "xla"),
            tuning_plan_path=(
                os.environ.get("TORCHMPI_TPU_TUNING_PLAN") or None),
            flash_prescale=_env_bool("TORCHMPI_TPU_FLASH_PRESCALE", False),
            fuse_max_bytes=_env_int("TORCHMPI_TPU_FUSE_MAX_BYTES",
                                    32 * 1024 * 1024),
            gradsync_average=_env_bool("TORCHMPI_TPU_GRADSYNC_AVERAGE", True),
            gradsync_compress=(
                os.environ.get("TORCHMPI_TPU_GRADSYNC_COMPRESS") or None),
            chunk_bytes=_env_int("TORCHMPI_TPU_CHUNK_BYTES", 4 * 1024 * 1024),
            custom_min_bytes=_env_int("TORCHMPI_TPU_CUSTOM_MIN_BYTES",
                                      64 * 1024),
            staged=_env_bool("TORCHMPI_TPU_STAGED", False),
            gradsync_buckets=_env_int("TORCHMPI_TPU_GRADSYNC_BUCKETS", 1),
            gradsync_overlap=_env_str("TORCHMPI_TPU_GRADSYNC_OVERLAP",
                                      "off"),
            gradsync_overlap_bytes=_env_int(
                "TORCHMPI_TPU_GRADSYNC_OVERLAP_BYTES", 0),
            gradsync_barrier=_env_bool("TORCHMPI_TPU_GRADSYNC_BARRIER",
                                       False),
            hierarchical=_env_bool("TORCHMPI_TPU_HIERARCHICAL", False),
            dcn_chunk_bytes=_env_int("TORCHMPI_TPU_DCN_CHUNK_BYTES",
                                     4 * 1024 * 1024),
            dcn_compress=_env_str("TORCHMPI_TPU_DCN_COMPRESS", "off"),
            dcn_compress_min_bytes=_env_int(
                "TORCHMPI_TPU_DCN_COMPRESS_MIN_BYTES", 64 * 1024),
            ps_timeout_s=ps_timeout_s(),
            analysis=_env_str("TORCHMPI_TPU_ANALYSIS", "off"),
            obs=_env_str("TORCHMPI_TPU_OBS", "off"),
        )
        for name, field in (("TORCHMPI_TPU_ICI_SIZE", "ici_size"),
                            ("TORCHMPI_TPU_DCN_SIZE", "dcn_size")):
            v = os.environ.get(name)
            if v is not None:
                setattr(cfg, field, int(v))
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown config field {k!r}")
            setattr(cfg, k, v)
        return cfg


def wire_compress(value, *, site: str) -> Optional[str]:
    """A wire-compression knob made canonical (the JAX package's
    ``gradsync._wire_compress``): None, "none", "off" or "" mean
    uncompressed and give None without importing the codec module;
    anything else goes through ``compress.validate_wire`` with
    ``allowed=("bf16",)``."""
    if value is None or value in ("none", "off", ""):
        return None
    from . import compress

    return compress.validate_wire(value, allowed=("bf16",), site=site)
