"""Observability layer of the port (counterpart of ``repro.obs``).

``metrics`` — the engine's in-loop telemetry accumulators with a lane
axis, and the host-side numpy reductions that turn them into
percentiles and cause breakdowns.  ``trace`` — Chrome-trace/Perfetto
export of the engine's time-series ring buffer.
"""
from . import metrics, trace  # noqa: F401
