"""Host-side utilities of the port: synthetic data (``data``), the
background host-to-card input pipeline (``input_pipeline``), the tree <->
flat float32 vector of the parameter server (``tree``), the native host
libraries (``native``), the asynchronous file writer (``aio``),
single-file checkpoints (``checkpoint``), timing (``metrics``), the
``sys.modules``-gated telemetry shim (``telemetry``) and profiler ranges
and traces (``tracing``)."""

from . import (aio, checkpoint, data, input_pipeline, metrics,  # noqa: F401
               native, telemetry, tracing, tree)
