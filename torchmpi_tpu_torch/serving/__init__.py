"""Continuous-batching serving over the port's decode stack (the JAX
package's ``torchmpi_tpu.serving``).

An admission queue and iteration-level scheduler (:mod:`.scheduler`)
inject newly arrived requests into the running decode batch at token
boundaries and retire finished sequences at once; a slot pool
(:mod:`.slots`) bounds cache memory at ``slots x slot_tokens``; a
health-routed router (:mod:`.router`) spreads sessions over dense
replicas (:mod:`.engine`) or tensor-parallel ones (:mod:`.tp_engine`,
``Server.sharded``: a slice of ranks each); a radix prefix cache (:mod:`.prefix_cache`)
prefills shared prompt prefixes once; speculative decoding (:mod:`.spec`)
lands up to K+1 tokens a target forward with the stream unchanged; SLO
admission control and autoscaling (:mod:`.fleet`) shed and scale.

Decode is per-request greedy or sampled (temperature / top-k / top-p /
seed on each :class:`Request`), reproducible from (seed, prompt), which
also keeps re-routing token-exact.  Greedy streams equal the offline
``models.generate.generate`` token for token.

Never imported unless used: nothing in the library imports this package.

    from torchmpi_tpu_torch import serving

    server = serving.Server(model, replicas=1, slots=8)
    done = server.run_trace([
        serving.Request("r0", prompt, max_new=32, arrival_s=0.0,
                        temperature=0.8, top_k=40, seed=7), ...])

With ``Config.obs`` on, the scheduler and the engines record the
``tm_serving_*`` telemetry (``python -m torchmpi_tpu_torch.obs.tool slo``
renders it).  With ``Config.faults`` armed the scheduler is the
``serving.replica`` and ``serving.admit`` chaos sites (a fault at the
door a typed shed, a dead replica drained and its sessions re-routed;
docs/FAULTS_TORCH.md).
"""

from __future__ import annotations

from .engine import ReplicaEngine, RequestRejected, Session  # noqa: F401
from .fleet import AdmissionController, AdmissionRejected, \
    FleetController  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401
from .router import Router  # noqa: F401
from .scheduler import Request, Server  # noqa: F401
from .slots import SlotPool  # noqa: F401
from .spec import ModelDraft, NgramDraft  # noqa: F401
from .tp_engine import TPReplicaEngine  # noqa: F401

__all__ = ["AdmissionController", "AdmissionRejected", "FleetController",
           "ModelDraft", "NgramDraft", "PrefixCache", "ReplicaEngine",
           "Request", "RequestRejected", "Router", "Server", "Session",
           "SlotPool", "TPReplicaEngine"]
