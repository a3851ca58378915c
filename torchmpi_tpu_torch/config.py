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


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return default if v is None or v == "" else float(v)


PS_TIMEOUT_S = 30.0

# Fenced rounds a candidate of an online tuning measurement
# (``tuning/measure.py``).  The JAX package's 3 leave the jitter at half
# the range of three single-call rounds: 0.020-0.044 ms for the ring at
# the ResNet-50 BatchNorm statistics' size (b17) in chip_smoke.py's
# auto_dp on an H100 80GB HBM3 at 700 W, above the gap between the
# candidates.  From four rounds on the jitter is half the inter-quartile
# range, which one slow round does not move.
TUNING_ROUNDS = 9


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
    - ``tuning_rounds``: fenced timing rounds a candidate in the online
      measurement (``tuning/measure.py``).  The default is
      :data:`TUNING_ROUNDS` (9), not the JAX package's 3 (ROADMAP queue C
      note 41).
    - ``backend_per_op``: per-verb overrides of ``backend`` (the
      reference's collectiveSelector table), e.g. ``{"allreduce":
      "pallas", "broadcast": "xla"}``; a verb's entry covers its process
      world and its rank-major form and has a per-call backend's
      authority (no size cutover).  ``init`` and ``set_config`` refuse an
      unknown verb or a backend with no implementation of it, and keep a
      private copy of the table.  A per-op ``"auto"`` arms the tuning
      plans as ``backend="auto"`` does.
    - ``use_accelerator``: the reference's ``mpi.start(withCuda)`` flag:
      ``init`` with no ``device`` argument runs on the card when True (the
      default) and on the CPU when False; an explicit ``device`` decides
      and is recorded here.  Fixed at init.
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
    - ``mesh_shape``: the N-D world, axis name -> size, major -> minor in
      dict order (one size may be -1, inferred), e.g. ``{"pp": 2, "dp": 2,
      "tp": 2}``; exclusive with ``dcn_size`` / ``ici_size``.  None (the
      default) is the two-level world (runtime.py).
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
    - ``analysis`` ("off" | "warn" | "error"; "1" / "true" / "yes" / "on"
      read as "warn"): the JAX package's runtime hook of the static
      collective analysis (``analysis/hook.py``): the step builders check
      each new batch signature once and the eager verbs each plan build,
      before the call's collectives launch; "warn" reports, "error" raises
      ``analysis.AnalysisError`` on an error finding; "off" never imports
      ``analysis``.
    - ``obs`` ("off" | "metrics" | "trace"; "1" / "true" / "yes" / "on"
      read as "metrics"): runtime telemetry (``obs/``): "off" (the
      default) never imports the layer; "metrics" keeps the counter /
      histogram registry and the flight recorder, a ring of the last
      ``obs_ring_size`` collective events, dumped per host as JSONL to
      ``obs_dir`` at exit, on SIGTERM or by ``obs.dump()``; "trace" adds
      each event's user call site.  ``obs_dir`` None resolves to
      TORCHMPI_TPU_OBS_DIR, then ``torchmpi_tpu_obs`` under the temporary
      directory (JAX ``config.py:212-230``).
    - The serving layer's defaults (``serving/``, never imported unless
      used; JAX ``config.py:477-518``): ``serving_slots`` (KV slot blocks
      a replica), ``serving_slot_tokens`` (tokens a block, 0 = the model's
      max_len; smaller only for RoPE models), ``serving_replicas``,
      ``serving_sample`` (default temperature, <= 0 greedy),
      ``serving_spec_k`` (speculative draft length, 0 off),
      ``serving_prefill_buckets`` (pow-2 prefill buckets of at least this
      many tokens, 0 off), ``serving_prefix_cache`` (prefix-cache blocks
      a replica, 0 off), ``serving_slo_ttft_us`` (shed arrivals while the
      p95 TTFT exceeds it, 0 off) and ``serving_autoscale`` (most replicas
      the autoscaler may reach, 0 off).
    - The fault layer (``faults/``, never imported while "off"; JAX
      ``config.py:405-426``): ``faults`` ("off" | "policy" | a fault-plan
      path; "1" / "true" / "yes" / "on" read as "policy": retries,
      deadlines and peer health armed on the host-staged, barrier, PS,
      aio and serving sites, a plan path injects too, and a corrupt or
      version-mismatched plan raises at init), ``fault_retries``
      (re-attempts after the first try, 0 off), ``fault_backoff_s``
      (first backoff, doubled a retry, deterministic jitter on top) and
      ``fault_deadline_s`` (a site's wall budget before a typed
      ``PeerTimeoutError``, 0 unbounded).
    - The collective watchdog (``watchdog.py``, never imported while
      "off"; JAX ``config.py:367-403``): ``watchdog`` ("off" | "warn" |
      "break"; "1" / "true" / "yes" / "on" read as "break"),
      ``watchdog_deadline_s`` (the age at which an in-flight wait is
      stalled; break at 1.5x, escalation at 2.5x), ``watchdog_poll_s``
      (the monitor's tick) and ``watchdog_dir`` (the lease directory;
      None: TORCHMPI_TPU_WATCHDOG_DIR, else no leases).
    - The durable checkpoints (``utils/durable.py``, never imported while
      "off"; JAX ``config.py:314-339``): ``ckpt_redundancy`` ("off" |
      "verify" | "buddy"; "1" / "true" / "yes" / "on" read as "buddy"):
      "verify" records a blake2b digest of each checkpoint file and checks
      it on every restore, "buddy" also mirrors each file to
      ``ckpt_buddies`` buddy locations and repairs a rotted or missing
      primary from them; ``ckpt_keep`` keeps the newest K steps a process
      (0 keeps all; enforced only while ``ckpt_redundancy`` is on), never
      the step a recovery settled on.
    - The guard (``guard.py``, never imported while "off"; JAX
      ``config.py:281-312``, docs/GUARD_TORCH.md): ``guard`` ("off" |
      "wire" | "numeric" | "full"; "1" / "true" / "yes" / "on" read as
      "full"): "wire" digests every host-staged payload and PS exchange at
      the sender and verifies it at the receiver, "numeric" arms the
      finite / norm-bound tripwire on the synced gradients, "full" both;
      ``guard_numeric_policy`` ("skip_step" | "raise"),
      ``guard_norm_bound`` (an L2 ceiling on a checked round, 0 checks
      finiteness only), ``guard_spike_window`` and ``guard_spike_threshold``
      (the rewind driver's loss-spike detector: its window in steps and
      its threshold in median absolute deviations).
    - The hot-state tier (``hotstate/``, never imported while "off"; JAX
      ``config.py:341-365``, docs/HOTSTATE_TORCH.md): ``hotstate`` ("off" |
      "on"), the consent gate of ``hotstate.enable``: after each completed
      step a rank ships its state delta to its buddy's RAM and
      ``restart.recover`` consults that RAM first; ``hotstate_interval``
      (every N-th stream is a full snapshot, 1 = every one) and
      ``hotstate_budget_mb`` (the RAM, in MiB, a process keeps for
      received replicas; the oldest generation goes first, never a peer's
      newest).
    - The elastic gang (``elastic.py`` and ``faults/membership.py``, never
      imported while "off"; JAX ``config.py:232-279``,
      docs/ELASTIC_TORCH.md): ``elastic`` ("off" | "on"), the consent gate
      of ``elastic.run_elastic``; ``elastic_dir`` (the membership board;
      None: ``<checkpoint directory>/membership``); ``elastic_poll_s`` and
      ``elastic_deadline_s`` (the board's poll and a reconcile round's
      deadline); ``elastic_quorum`` ("off" | "majority"; "on" reads as
      "majority"): a view commits only with a majority of the last
      committed view, and the epoch fence is armed.
    - ``coordinator_address`` / ``num_processes`` / ``process_id``: the
      process world's rendezvous (JAX ``config.py:521-523``): with an
      address (``host:port``, or any ``init_method`` URL), ``init`` joins
      that world as ``process_id`` of ``num_processes``.  Unset, the
      launcher's environment decides (``TORCHMPI_TPU_COORDINATOR`` /
      ``_NUM_PROCESSES`` / ``_PROCESS_ID``, then ``MASTER_ADDR`` /
      ``RANK`` / ``WORLD_SIZE``).
    """

    use_accelerator: bool = True
    backend: str = "xla"
    tuning_plan_path: Optional[str] = None
    tuning_rounds: int = TUNING_ROUNDS
    backend_per_op: Optional[dict] = None
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
    mesh_shape: Optional[dict] = None
    dcn_size: Optional[int] = None
    ici_size: Optional[int] = None
    hierarchical: bool = False
    dcn_chunk_bytes: int = 4 * 1024 * 1024
    dcn_compress: str = "off"
    dcn_compress_min_bytes: int = 64 * 1024
    ps_timeout_s: float = PS_TIMEOUT_S
    analysis: str = "off"
    obs: str = "off"
    obs_dir: Optional[str] = None
    obs_ring_size: int = 1024
    serving_slots: int = 8
    serving_slot_tokens: int = 0
    serving_replicas: int = 1
    serving_sample: float = 0.0
    serving_spec_k: int = 0
    serving_prefill_buckets: int = 0
    serving_prefix_cache: int = 0
    serving_slo_ttft_us: float = 0.0
    serving_autoscale: int = 0
    faults: str = "off"
    fault_retries: int = 2
    fault_backoff_s: float = 0.05
    fault_deadline_s: float = 30.0
    watchdog: str = "off"
    watchdog_deadline_s: float = 30.0
    watchdog_poll_s: float = 0.05
    watchdog_dir: Optional[str] = None
    ckpt_redundancy: str = "off"
    ckpt_buddies: int = 1
    ckpt_keep: int = 0
    hotstate: str = "off"
    hotstate_interval: int = 8
    hotstate_budget_mb: int = 64
    guard: str = "off"
    guard_numeric_policy: str = "skip_step"
    guard_norm_bound: float = 0.0
    guard_spike_window: int = 16
    guard_spike_threshold: float = 8.0
    elastic: str = "off"
    elastic_dir: Optional[str] = None
    elastic_poll_s: float = 0.05
    elastic_deadline_s: float = 30.0
    elastic_quorum: str = "off"
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    @staticmethod
    def from_env(**overrides) -> "Config":
        """Build a Config from the environment
        (TORCHMPI_TPU_BACKEND,
        TORCHMPI_TPU_TUNING_PLAN, TORCHMPI_TPU_TUNING_ROUNDS,
        TORCHMPI_TPU_FLASH_PRESCALE, TORCHMPI_TPU_FUSE_MAX_BYTES,
        TORCHMPI_TPU_GRADSYNC_AVERAGE, TORCHMPI_TPU_GRADSYNC_COMPRESS,
        TORCHMPI_TPU_CHUNK_BYTES, TORCHMPI_TPU_CUSTOM_MIN_BYTES,
        TORCHMPI_TPU_STAGED, TORCHMPI_TPU_GRADSYNC_BUCKETS,
        TORCHMPI_TPU_GRADSYNC_OVERLAP, TORCHMPI_TPU_GRADSYNC_OVERLAP_BYTES,
        TORCHMPI_TPU_GRADSYNC_BARRIER, TORCHMPI_TPU_MESH_SHAPE
        (``name=size,name=size``), TORCHMPI_TPU_DCN_SIZE,
        TORCHMPI_TPU_ICI_SIZE, TORCHMPI_TPU_HIERARCHICAL,
        TORCHMPI_TPU_DCN_CHUNK_BYTES, TORCHMPI_TPU_DCN_COMPRESS,
        TORCHMPI_TPU_DCN_COMPRESS_MIN_BYTES, TORCHMPI_TPU_PS_TIMEOUT (see
        :func:`ps_timeout_s`), TORCHMPI_TPU_ANALYSIS, TORCHMPI_TPU_OBS,
        TORCHMPI_TPU_OBS_DIR, TORCHMPI_TPU_OBS_RING,
        TORCHMPI_TPU_SERVING_SLOTS, _SLOT_TOKENS, _REPLICAS, _SAMPLE,
        _SPEC_K, _PREFILL_BUCKETS, _PREFIX_CACHE, _SLO_TTFT_US and
        _AUTOSCALE (each after TORCHMPI_TPU_SERVING),
        TORCHMPI_TPU_FAULTS, TORCHMPI_TPU_FAULT_RETRIES, _FAULT_BACKOFF,
        _FAULT_DEADLINE, TORCHMPI_TPU_WATCHDOG, _WATCHDOG_DEADLINE,
        _WATCHDOG_POLL and _WATCHDOG_DIR, TORCHMPI_TPU_CKPT_REDUNDANCY,
        _CKPT_BUDDIES and _CKPT_KEEP, TORCHMPI_TPU_GUARD, _GUARD_POLICY,
        _GUARD_NORM_BOUND, _GUARD_WINDOW and _GUARD_THRESHOLD,
        TORCHMPI_TPU_HOTSTATE, _HOTSTATE_INTERVAL and _HOTSTATE_BUDGET_MB,
        TORCHMPI_TPU_ELASTIC, _ELASTIC_DIR, _ELASTIC_POLL, _ELASTIC_DEADLINE
        and _ELASTIC_QUORUM (JAX ``config.py:548-562``);
        ``use_accelerator`` (no variable changes the device),
        ``pallas_bidirectional``, ``backend_per_op`` and the three
        process-world fields have none here: ``init`` reads
        TORCHMPI_TPU_COORDINATOR and its two companions), then apply
        ``overrides``."""
        cfg = Config(
            backend=_env_str("TORCHMPI_TPU_BACKEND", "xla"),
            tuning_plan_path=(
                os.environ.get("TORCHMPI_TPU_TUNING_PLAN") or None),
            tuning_rounds=_env_int("TORCHMPI_TPU_TUNING_ROUNDS",
                                   TUNING_ROUNDS),
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
            obs_dir=(os.environ.get("TORCHMPI_TPU_OBS_DIR") or None),
            obs_ring_size=_env_int("TORCHMPI_TPU_OBS_RING", 1024),
            serving_slots=_env_int("TORCHMPI_TPU_SERVING_SLOTS", 8),
            serving_slot_tokens=_env_int(
                "TORCHMPI_TPU_SERVING_SLOT_TOKENS", 0),
            serving_replicas=_env_int("TORCHMPI_TPU_SERVING_REPLICAS", 1),
            serving_sample=_env_float("TORCHMPI_TPU_SERVING_SAMPLE", 0.0),
            serving_spec_k=_env_int("TORCHMPI_TPU_SERVING_SPEC_K", 0),
            serving_prefill_buckets=_env_int(
                "TORCHMPI_TPU_SERVING_PREFILL_BUCKETS", 0),
            serving_prefix_cache=_env_int(
                "TORCHMPI_TPU_SERVING_PREFIX_CACHE", 0),
            serving_slo_ttft_us=_env_float(
                "TORCHMPI_TPU_SERVING_SLO_TTFT_US", 0.0),
            serving_autoscale=_env_int("TORCHMPI_TPU_SERVING_AUTOSCALE", 0),
            faults=_env_str("TORCHMPI_TPU_FAULTS", "off"),
            fault_retries=_env_int("TORCHMPI_TPU_FAULT_RETRIES", 2),
            fault_backoff_s=_env_float("TORCHMPI_TPU_FAULT_BACKOFF", 0.05),
            fault_deadline_s=_env_float("TORCHMPI_TPU_FAULT_DEADLINE",
                                        30.0),
            watchdog=_env_str("TORCHMPI_TPU_WATCHDOG", "off"),
            watchdog_deadline_s=_env_float(
                "TORCHMPI_TPU_WATCHDOG_DEADLINE", 30.0),
            watchdog_poll_s=_env_float("TORCHMPI_TPU_WATCHDOG_POLL", 0.05),
            watchdog_dir=(os.environ.get("TORCHMPI_TPU_WATCHDOG_DIR")
                          or None),
            ckpt_redundancy=_env_str("TORCHMPI_TPU_CKPT_REDUNDANCY", "off"),
            ckpt_buddies=_env_int("TORCHMPI_TPU_CKPT_BUDDIES", 1),
            ckpt_keep=_env_int("TORCHMPI_TPU_CKPT_KEEP", 0),
            hotstate=_env_str("TORCHMPI_TPU_HOTSTATE", "off"),
            hotstate_interval=_env_int("TORCHMPI_TPU_HOTSTATE_INTERVAL", 8),
            hotstate_budget_mb=_env_int("TORCHMPI_TPU_HOTSTATE_BUDGET_MB",
                                        64),
            guard=_env_str("TORCHMPI_TPU_GUARD", "off"),
            guard_numeric_policy=_env_str("TORCHMPI_TPU_GUARD_POLICY",
                                          "skip_step"),
            guard_norm_bound=_env_float("TORCHMPI_TPU_GUARD_NORM_BOUND",
                                        0.0),
            guard_spike_window=_env_int("TORCHMPI_TPU_GUARD_WINDOW", 16),
            guard_spike_threshold=_env_float("TORCHMPI_TPU_GUARD_THRESHOLD",
                                             8.0),
            elastic=_env_str("TORCHMPI_TPU_ELASTIC", "off"),
            elastic_dir=(os.environ.get("TORCHMPI_TPU_ELASTIC_DIR")
                         or None),
            elastic_poll_s=_env_float("TORCHMPI_TPU_ELASTIC_POLL", 0.05),
            elastic_deadline_s=_env_float("TORCHMPI_TPU_ELASTIC_DEADLINE",
                                          30.0),
            elastic_quorum=_env_str("TORCHMPI_TPU_ELASTIC_QUORUM", "off"),
        )
        for name, field in (("TORCHMPI_TPU_ICI_SIZE", "ici_size"),
                            ("TORCHMPI_TPU_DCN_SIZE", "dcn_size")):
            v = os.environ.get(name)
            if v is not None:
                setattr(cfg, field, int(v))
        mesh = os.environ.get("TORCHMPI_TPU_MESH_SHAPE")
        if mesh:
            cfg.mesh_shape = {}
            for part in mesh.split(","):
                name, _, size = part.partition("=")
                if not name.strip() or not size.strip():
                    raise ValueError(
                        f"TORCHMPI_TPU_MESH_SHAPE: malformed entry {part!r} "
                        "(want name=size,name=size,...)")
                cfg.mesh_shape[name.strip()] = int(size)
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown config field {k!r}")
            setattr(cfg, k, v)
        check_serving(cfg)
        return cfg


def normalize_obs(value) -> Optional[str]:
    """Canonical obs mode for a config or environment value (JAX
    ``runtime.py:147``): "off" | "metrics" | "trace", with boolean-ish
    spellings ("1" / "true" / "yes" / "on" mean "metrics"; "0" /
    "false" / "no" / "none" / "" mean "off").  None: unrecognized (the
    caller raises)."""
    v = str(value).strip().lower()
    if v in ("off", "0", "false", "no", "none", ""):
        return "off"
    if v in ("metrics", "1", "true", "yes", "on"):
        return "metrics"
    if v == "trace":
        return "trace"
    return None


def resolve_obs(cfg: Config) -> None:
    """``cfg.obs`` made canonical in place, with the JAX runtime's
    any-config pickup (:436-444): a field left "off" defers to
    TORCHMPI_TPU_OBS, so ``TORCHMPI_TPU_OBS=metrics python script.py``
    turns it on even where the script builds its Config explicitly."""
    if normalize_obs(cfg.obs) == "off":
        cfg.obs = os.environ.get("TORCHMPI_TPU_OBS", "off")
    mode = normalize_obs(cfg.obs)
    if mode is None:
        raise ValueError("config.obs (or TORCHMPI_TPU_OBS) must be "
                         "off|metrics|trace")
    cfg.obs = mode
    if int(cfg.obs_ring_size) < 1:
        raise ValueError(f"config.obs_ring_size must be >= 1, got "
                         f"{cfg.obs_ring_size}")


def normalize_faults(value) -> str:
    """Canonical faults mode (JAX ``runtime.py:283``): "off", "policy",
    or a fault-plan path kept verbatim ("0" / "false" / "no" / "none" /
    "" mean "off", "1" / "true" / "yes" / "on" mean "policy"); a typo'd
    path fails loudly when the plan loads."""
    v = str(value).strip()
    low = v.lower()
    if low in ("off", "0", "false", "no", "none", ""):
        return "off"
    if low in ("policy", "on", "1", "true", "yes"):
        return "policy"
    return v


def normalize_watchdog(value) -> Optional[str]:
    """Canonical watchdog mode (JAX ``runtime.py:240``): "off" | "warn" |
    "break" ("1" / "true" / "yes" / "on" mean "break"); None:
    unrecognized (the caller raises)."""
    v = str(value).strip().lower()
    if v in ("off", "0", "false", "no", "none", ""):
        return "off"
    if v in ("break", "on", "1", "true", "yes"):
        return "break"
    if v == "warn":
        return v
    return None


def normalize_ckpt_redundancy(value) -> Optional[str]:
    """Canonical ckpt_redundancy mode (JAX ``runtime.py:256``): "off" |
    "verify" | "buddy" ("1" / "true" / "yes" / "on" mean "buddy"); None:
    unrecognized (the caller raises)."""
    v = str(value).strip().lower()
    if v in ("off", "0", "false", "no", "none", ""):
        return "off"
    if v in ("buddy", "on", "1", "true", "yes"):
        return "buddy"
    if v == "verify":
        return v
    return None


def _env_default_pickup(cfg: Config, field: str, env: str, cast) -> None:
    """A knob left at its default defers to the environment; an explicit
    value wins (JAX ``runtime.py:299``)."""
    raw = os.environ.get(env)
    if not raw:
        return
    default = next(f.default for f in dataclasses.fields(Config)
                   if f.name == field)
    if getattr(cfg, field) == default:
        setattr(cfg, field, cast(raw))


def resolve_faults(cfg: Config) -> None:
    """The fault and watchdog fields made canonical in place, with the
    JAX runtime's any-config pickup (:448-518): a mode left "off" and a
    knob left at its default defer to the environment; the watchdog's
    mode and times are checked with JAX's messages."""
    if normalize_faults(cfg.faults) == "off":
        cfg.faults = os.environ.get("TORCHMPI_TPU_FAULTS", "off")
    cfg.faults = normalize_faults(cfg.faults)
    _env_default_pickup(cfg, "fault_retries", "TORCHMPI_TPU_FAULT_RETRIES",
                        int)
    _env_default_pickup(cfg, "fault_backoff_s", "TORCHMPI_TPU_FAULT_BACKOFF",
                        float)
    _env_default_pickup(cfg, "fault_deadline_s",
                        "TORCHMPI_TPU_FAULT_DEADLINE", float)
    if normalize_watchdog(cfg.watchdog) == "off":
        cfg.watchdog = os.environ.get("TORCHMPI_TPU_WATCHDOG", "off")
    mode = normalize_watchdog(cfg.watchdog)
    if mode is None:
        raise ValueError("config.watchdog (or TORCHMPI_TPU_WATCHDOG) must be "
                         "off|warn|break")
    cfg.watchdog = mode
    _env_default_pickup(cfg, "watchdog_deadline_s",
                        "TORCHMPI_TPU_WATCHDOG_DEADLINE", float)
    _env_default_pickup(cfg, "watchdog_poll_s", "TORCHMPI_TPU_WATCHDOG_POLL",
                        float)
    if cfg.watchdog_dir is None:
        cfg.watchdog_dir = os.environ.get("TORCHMPI_TPU_WATCHDOG_DIR") or None
    if cfg.watchdog_deadline_s <= 0 or cfg.watchdog_poll_s <= 0:
        raise ValueError(
            f"config.watchdog_deadline_s and watchdog_poll_s must be > 0, "
            f"got {cfg.watchdog_deadline_s}/{cfg.watchdog_poll_s}")


def resolve_ckpt(cfg: Config) -> None:
    """The durable-checkpoint fields made canonical in place, with the
    JAX runtime's any-config pickup and messages (:519-540)."""
    if normalize_ckpt_redundancy(cfg.ckpt_redundancy) == "off":
        cfg.ckpt_redundancy = os.environ.get("TORCHMPI_TPU_CKPT_REDUNDANCY",
                                             "off")
    mode = normalize_ckpt_redundancy(cfg.ckpt_redundancy)
    if mode is None:
        raise ValueError("config.ckpt_redundancy (or "
                         "TORCHMPI_TPU_CKPT_REDUNDANCY) must be "
                         "off|verify|buddy")
    cfg.ckpt_redundancy = mode
    _env_default_pickup(cfg, "ckpt_buddies", "TORCHMPI_TPU_CKPT_BUDDIES",
                        int)
    _env_default_pickup(cfg, "ckpt_keep", "TORCHMPI_TPU_CKPT_KEEP", int)
    if cfg.ckpt_buddies < 1 or cfg.ckpt_keep < 0:
        raise ValueError(
            f"config.ckpt_buddies must be >= 1 and ckpt_keep >= 0 (0 = keep "
            f"everything), got {cfg.ckpt_buddies}/{cfg.ckpt_keep}")


def normalize_guard(value) -> Optional[str]:
    """Canonical guard mode (JAX ``runtime.py:224``): "off" | "wire" |
    "numeric" | "full" ("1" / "true" / "yes" / "on" mean "full"); None:
    unrecognized (the caller raises)."""
    v = str(value).strip().lower()
    if v in ("off", "0", "false", "no", "none", ""):
        return "off"
    if v in ("full", "on", "1", "true", "yes"):
        return "full"
    if v in ("wire", "numeric"):
        return v
    return None


def normalize_guard_policy(value) -> Optional[str]:
    """Canonical guard_numeric_policy (JAX ``runtime.py:272``):
    "skip_step" ("skip" too) | "raise"; None: unrecognized."""
    v = str(value).strip().lower()
    if v in ("skip_step", "skip"):
        return "skip_step"
    if v == "raise":
        return "raise"
    return None


def normalize_elastic(value) -> Optional[str]:
    """Canonical elastic mode (JAX ``runtime.py:187``): "off" | "on",
    boolean-ish spellings accepted; None: unrecognized."""
    v = str(value).strip().lower()
    if v in ("off", "0", "false", "no", "none", ""):
        return "off"
    if v in ("on", "1", "true", "yes"):
        return "on"
    return None


def normalize_elastic_quorum(value) -> Optional[str]:
    """Canonical elastic_quorum mode (JAX ``runtime.py:211``): "off" |
    "majority" ("1" / "true" / "yes" / "on" mean "majority"); None:
    unrecognized."""
    v = str(value).strip().lower()
    if v in ("off", "0", "false", "no", "none", ""):
        return "off"
    if v in ("majority", "on", "1", "true", "yes"):
        return "majority"
    return None


def resolve_guard_elastic(cfg: Config) -> None:
    """The guard and elastic fields made canonical in place, with the JAX
    runtime's any-config pickup and messages (:462-495, :562-595): a mode
    left "off" and a knob left at its default defer to the environment."""
    if normalize_guard(cfg.guard) == "off":
        cfg.guard = os.environ.get("TORCHMPI_TPU_GUARD", "off")
    mode = normalize_guard(cfg.guard)
    if mode is None:
        raise ValueError("config.guard (or TORCHMPI_TPU_GUARD) must be "
                         "off|wire|numeric|full")
    cfg.guard = mode
    policy = normalize_guard_policy(cfg.guard_numeric_policy)
    if policy is None:
        raise ValueError("config.guard_numeric_policy (or "
                         "TORCHMPI_TPU_GUARD_POLICY) must be skip_step|raise")
    cfg.guard_numeric_policy = policy
    _env_default_pickup(cfg, "guard_norm_bound",
                        "TORCHMPI_TPU_GUARD_NORM_BOUND", float)
    _env_default_pickup(cfg, "guard_spike_window",
                        "TORCHMPI_TPU_GUARD_WINDOW", int)
    _env_default_pickup(cfg, "guard_spike_threshold",
                        "TORCHMPI_TPU_GUARD_THRESHOLD", float)
    if cfg.guard_norm_bound < 0:
        raise ValueError(f"config.guard_norm_bound must be >= 0 (0 = "
                         f"finite-only), got {cfg.guard_norm_bound}")
    if cfg.guard_spike_window < 2 or cfg.guard_spike_threshold <= 0:
        raise ValueError(
            f"config.guard_spike_window must be >= 2 and "
            f"guard_spike_threshold > 0, got "
            f"{cfg.guard_spike_window}/{cfg.guard_spike_threshold}")
    if normalize_elastic(cfg.elastic) == "off":
        cfg.elastic = os.environ.get("TORCHMPI_TPU_ELASTIC", "off")
    mode = normalize_elastic(cfg.elastic)
    if mode is None:
        raise ValueError("config.elastic (or TORCHMPI_TPU_ELASTIC) must be "
                         "off|on")
    cfg.elastic = mode
    if cfg.elastic_dir is None:
        cfg.elastic_dir = os.environ.get("TORCHMPI_TPU_ELASTIC_DIR") or None
    _env_default_pickup(cfg, "elastic_poll_s", "TORCHMPI_TPU_ELASTIC_POLL",
                        float)
    _env_default_pickup(cfg, "elastic_deadline_s",
                        "TORCHMPI_TPU_ELASTIC_DEADLINE", float)
    if cfg.elastic_poll_s <= 0 or cfg.elastic_deadline_s <= 0:
        raise ValueError(
            f"config.elastic_poll_s and elastic_deadline_s must be > 0, got "
            f"{cfg.elastic_poll_s}/{cfg.elastic_deadline_s}")
    if normalize_elastic_quorum(cfg.elastic_quorum) == "off":
        cfg.elastic_quorum = os.environ.get("TORCHMPI_TPU_ELASTIC_QUORUM",
                                            "off")
    mode = normalize_elastic_quorum(cfg.elastic_quorum)
    if mode is None:
        raise ValueError("config.elastic_quorum (or "
                         "TORCHMPI_TPU_ELASTIC_QUORUM) must be off|majority")
    cfg.elastic_quorum = mode


def check_guard_elastic_override(k: str, v):
    """One ``set_config`` value of a guard or elastic field, made
    canonical and checked as the JAX ``set_config`` does (:908-980)."""
    if k == "guard":
        v = normalize_guard(v)
        if v is None:
            raise ValueError("config.guard must be off|wire|numeric|full")
    if k == "guard_numeric_policy":
        v = normalize_guard_policy(v)
        if v is None:
            raise ValueError(
                "config.guard_numeric_policy must be skip_step|raise")
    if k == "guard_norm_bound":
        v = float(v)
        if v < 0:
            raise ValueError(
                "config.guard_norm_bound must be >= 0 (0 = finite-only)")
    if k == "guard_spike_window":
        v = int(v)
        if v < 2:
            raise ValueError("config.guard_spike_window must be >= 2")
    if k == "guard_spike_threshold":
        v = float(v)
        if v <= 0:
            raise ValueError("config.guard_spike_threshold must be > 0")
    if k == "elastic":
        v = normalize_elastic(v)
        if v is None:
            raise ValueError("config.elastic must be off|on")
    if k in ("elastic_poll_s", "elastic_deadline_s"):
        v = float(v)
        if v <= 0:
            raise ValueError(f"config.{k} must be > 0")
    if k == "elastic_quorum":
        v = normalize_elastic_quorum(v)
        if v is None:
            raise ValueError("config.elastic_quorum must be off|majority")
    if k == "elastic_dir":
        v = v or None
    return v


GUARD_ELASTIC_FIELDS = frozenset({
    "guard", "guard_numeric_policy", "guard_norm_bound",
    "guard_spike_window", "guard_spike_threshold", "elastic", "elastic_dir",
    "elastic_poll_s", "elastic_deadline_s", "elastic_quorum"})


def check_fault_override(k: str, v):
    """One ``set_config`` value of a fault, watchdog or durable-checkpoint
    field, made canonical and checked as the JAX ``set_config`` does
    (:906-955)."""
    if k == "faults":
        return normalize_faults(v)
    if k == "fault_retries":
        return int(v)
    if k in ("fault_backoff_s", "fault_deadline_s"):
        return float(v)
    if k == "watchdog":
        mode = normalize_watchdog(v)
        if mode is None:
            raise ValueError("config.watchdog must be off|warn|break")
        return mode
    if k in ("watchdog_deadline_s", "watchdog_poll_s"):
        v = float(v)
        if v <= 0:
            raise ValueError(f"config.{k} must be > 0")
    if k == "ckpt_redundancy":
        v = normalize_ckpt_redundancy(v)
        if v is None:
            raise ValueError("config.ckpt_redundancy must be off|verify|buddy")
    if k == "ckpt_buddies":
        v = int(v)
        if v < 1:
            raise ValueError("config.ckpt_buddies must be >= 1")
    if k == "ckpt_keep":
        v = int(v)
        if v < 0:
            raise ValueError(
                "config.ckpt_keep must be >= 0 (0 = keep everything)")
    return v


def normalize_analysis(value) -> Optional[str]:
    """Canonical analysis mode (JAX ``runtime.py:132``): "off" | "warn" |
    "error" ("1" / "true" / "yes" / "on" mean "warn"); None:
    unrecognized (the caller raises)."""
    v = str(value).strip().lower()
    if v in ("off", "0", "false", "no", "none", ""):
        return "off"
    if v in ("warn", "1", "true", "yes", "on"):
        return "warn"
    if v == "error":
        return v
    return None


def normalize_hotstate(value) -> Optional[str]:
    """Canonical hotstate mode (JAX ``runtime.py:199``): "off" | "on",
    boolean-ish spellings accepted; None: unrecognized."""
    return normalize_elastic(value)


def resolve_analysis_hotstate(cfg: Config) -> None:
    """The analysis and hot-state fields made canonical in place, with the
    JAX runtime's any-config pickup and messages (:427-433, :543-562): a
    mode left "off" and a knob left at its default defer to the
    environment."""
    if normalize_analysis(cfg.analysis) == "off":
        cfg.analysis = os.environ.get("TORCHMPI_TPU_ANALYSIS", "off")
    mode = normalize_analysis(cfg.analysis)
    if mode is None:
        raise ValueError("config.analysis (or TORCHMPI_TPU_ANALYSIS) must be "
                         "off|warn|error")
    cfg.analysis = mode
    if normalize_hotstate(cfg.hotstate) == "off":
        cfg.hotstate = os.environ.get("TORCHMPI_TPU_HOTSTATE", "off")
    mode = normalize_hotstate(cfg.hotstate)
    if mode is None:
        raise ValueError("config.hotstate (or TORCHMPI_TPU_HOTSTATE) must be "
                         "off|on")
    cfg.hotstate = mode
    _env_default_pickup(cfg, "hotstate_interval",
                        "TORCHMPI_TPU_HOTSTATE_INTERVAL", int)
    _env_default_pickup(cfg, "hotstate_budget_mb",
                        "TORCHMPI_TPU_HOTSTATE_BUDGET_MB", int)
    if cfg.hotstate_interval < 1 or cfg.hotstate_budget_mb < 1:
        raise ValueError(
            f"config.hotstate_interval and hotstate_budget_mb must be >= 1, "
            f"got {cfg.hotstate_interval}/{cfg.hotstate_budget_mb}")


def resolve_serving(cfg: Config) -> None:
    """The serving knobs with the JAX runtime's any-config pickup
    (:594-614): a knob left at its default defers to the environment;
    then :func:`check_serving`."""
    _env_default_pickup(cfg, "serving_slots", "TORCHMPI_TPU_SERVING_SLOTS",
                        int)
    _env_default_pickup(cfg, "serving_slot_tokens",
                        "TORCHMPI_TPU_SERVING_SLOT_TOKENS", int)
    _env_default_pickup(cfg, "serving_replicas",
                        "TORCHMPI_TPU_SERVING_REPLICAS", int)
    _env_default_pickup(cfg, "serving_sample", "TORCHMPI_TPU_SERVING_SAMPLE",
                        float)
    _env_default_pickup(cfg, "serving_spec_k", "TORCHMPI_TPU_SERVING_SPEC_K",
                        int)
    _env_default_pickup(cfg, "serving_prefill_buckets",
                        "TORCHMPI_TPU_SERVING_PREFILL_BUCKETS", int)
    _env_default_pickup(cfg, "serving_prefix_cache",
                        "TORCHMPI_TPU_SERVING_PREFIX_CACHE", int)
    _env_default_pickup(cfg, "serving_slo_ttft_us",
                        "TORCHMPI_TPU_SERVING_SLO_TTFT_US", float)
    _env_default_pickup(cfg, "serving_autoscale",
                        "TORCHMPI_TPU_SERVING_AUTOSCALE", int)
    check_serving(cfg)


def check_override(k: str, v):
    """One ``set_config`` value of an analysis, hot-state or serving field,
    made canonical and checked as the JAX ``set_config`` does (:897-901,
    :960-967, :1002-1028)."""
    if k == "analysis":
        v = normalize_analysis(v)
        if v is None:
            raise ValueError("config.analysis must be off|warn|error")
    if k == "hotstate":
        v = normalize_hotstate(v)
        if v is None:
            raise ValueError("config.hotstate must be off|on")
    if k in ("hotstate_interval", "hotstate_budget_mb"):
        v = int(v)
        if v < 1:
            raise ValueError(f"config.{k} must be >= 1")
    if k in ("serving_slots", "serving_replicas"):
        v = int(v)
        if v < 1:
            raise ValueError(f"config.{k} must be >= 1")
    if k == "serving_slot_tokens":
        v = int(v)
        if v < 0:
            raise ValueError("config.serving_slot_tokens must be >= 0 "
                             "(0 = model max_len)")
    if k == "serving_sample":
        v = float(v)  # <= 0 means greedy: only the type is pinned
    if k in ("serving_spec_k", "serving_prefill_buckets",
             "serving_prefix_cache", "serving_autoscale"):
        v = int(v)
        if v < 0:
            raise ValueError(f"config.{k} must be >= 0 (0 = off)")
    if k == "serving_slo_ttft_us":
        v = float(v)
        if v < 0:
            raise ValueError("config.serving_slo_ttft_us must be >= 0 "
                             "(0 = admit everything)")
    return v


OVERRIDE_FIELDS = frozenset({
    "analysis", "hotstate", "hotstate_interval", "hotstate_budget_mb",
    "serving_slots", "serving_slot_tokens", "serving_replicas",
    "serving_sample", "serving_spec_k", "serving_prefill_buckets",
    "serving_prefix_cache", "serving_slo_ttft_us", "serving_autoscale"})


def check_serving(cfg: Config) -> None:
    """The serving fields' ranges, with the JAX runtime's messages
    (JAX ``runtime.py:615-633``)."""
    if cfg.serving_prefix_cache < 0 or cfg.serving_autoscale < 0 \
            or cfg.serving_slo_ttft_us < 0:
        raise ValueError(
            f"config.serving_prefix_cache / serving_autoscale / "
            f"serving_slo_ttft_us must be >= 0 (0 = off), got "
            f"{cfg.serving_prefix_cache}/{cfg.serving_autoscale}/"
            f"{cfg.serving_slo_ttft_us}")
    if cfg.serving_spec_k < 0 or cfg.serving_prefill_buckets < 0:
        raise ValueError(
            f"config.serving_spec_k and serving_prefill_buckets "
            f"must be >= 0 (0 = off), got {cfg.serving_spec_k}/"
            f"{cfg.serving_prefill_buckets}")
    if cfg.serving_slots < 1 or cfg.serving_replicas < 1 \
            or cfg.serving_slot_tokens < 0:
        raise ValueError(
            f"config.serving_slots/serving_replicas must be >= 1 and "
            f"serving_slot_tokens >= 0 (0 = model max_len), got "
            f"{cfg.serving_slots}/{cfg.serving_replicas}/"
            f"{cfg.serving_slot_tokens}")


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
