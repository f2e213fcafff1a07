"""Chrome-trace / Perfetto export of the engine's ring buffer — the port
of ``repro/obs/trace.py`` (numpy only).

The engine samples ``len(metrics.TRACE_CHANNELS)`` channels into a
bounded ``f32[trace_len, C]`` ring per lane every ``EngCfg.trace_every``
iterations.  This module turns one or more rings into Chrome's
trace-event JSON: counter events (``"ph": "C"``) over simulated time.
Rows whose ``now`` channel is negative are unused; rows are emitted
sorted by ``now``, so a wrapped ring renders as a monotone timeline.
"""
from __future__ import annotations

import json

import numpy as np

from . import metrics as M


def trace_rows(trace) -> np.ndarray:
    """Valid rows of one ring buffer, sorted by simulated time."""
    t = np.asarray(trace, dtype=np.float64).reshape(-1, len(M.TRACE_CHANNELS))
    t = t[t[:, 0] >= 0.0]
    return t[np.argsort(t[:, 0], kind="stable")]


def chrome_trace_events(trace, label: str = "engine",
                        pid: int = 0) -> list:
    """Counter events for one ring buffer: one ``"ph": "C"`` event per
    sample per channel (``now`` is the timestamp).  ``label`` names the
    process so several lanes can share a file."""
    rows = trace_rows(trace)
    events = [{"name": "process_name", "ph": "M", "pid": pid,
               "args": {"name": label}}]
    for row in rows:
        ts = float(row[0])
        for ci, ch in enumerate(M.TRACE_CHANNELS):
            if ci == 0:
                continue
            events.append({"name": ch, "ph": "C", "pid": pid, "tid": 0,
                           "ts": ts, "args": {ch: float(row[ci])}})
    return events


def write_chrome_trace(path, traces, meta: dict | None = None) -> int:
    """Write Chrome-trace JSON for ``traces`` — one ring buffer or a
    ``{label: trace}`` dict (one counter track per lane).  Returns the
    number of events written."""
    if not isinstance(traces, dict):
        traces = {"engine": traces}
    events = []
    for pid, (label, trace) in enumerate(traces.items()):
        events.extend(chrome_trace_events(trace, label=label, pid=pid))
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": meta or {}}
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return len(events)
