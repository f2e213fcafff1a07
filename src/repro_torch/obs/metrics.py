"""Telemetry accumulator layout and host-side reductions — the port of
``repro/obs/metrics.py``.

The engine keeps every statistic as a fixed-shape tensor folded with
masked scatters: log-spaced latency and wait histograms, a clipped
restart-count histogram, the abort and block cause taxonomies and a
time-series ring buffer.  Here each leaf carries the fleet's lane axis
(``Telemetry`` below).  The host-side reductions (percentiles,
summaries, ``HostHist``) are numpy-only copies of the reference's, so
both packages bin and summarise the same arrays identically.

Histogram convention: ``NBINS`` bins over a value ``v >= 0`` with
``bin = searchsorted(EDGES, v, side="right")`` — bin 0 holds ``v <= 1``,
the last bin ``v > 1e6`` — over log-spaced interior edges.  The engine
bins float32 values against ``EDGES`` cast to float32.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

NBINS = 64
EDGES = np.geomspace(1.0, 1e6, NBINS - 1)

# restart-count histogram: bin r = min(restarts, RBINS - 1)
RBINS = 16

# Abort causes, in the order the engine partitions an aborting slot:
#   block_timeout   — read-phase block expired
#   wc_timeout      — wait-to-commit lock acquisition timed out
#   precedence      — Fig. 3 circular-wait abort (PPCC)
#   validate_read   — OCC validation failed at read-phase end
#   validate_commit — OCC commit-time re-validation failed
ABORT_CAUSES = ("block_timeout", "wc_timeout", "precedence",
                "validate_read", "validate_commit")

# Block-episode causes: lock and rule partition the engine's read-phase
# `blocks` counter; wc_lock counts entries into the wait-to-commit
# lock-wait state.
BLOCK_CAUSES = ("lock", "rule", "wc_lock")

# Ring-buffer channels, sampled every EngCfg.trace_every iterations
# (``now`` < 0 marks an unused row).
TRACE_CHANNELS = ("now", "ready", "blocked", "waiting", "commits",
                  "aborts", "selected", "degree")

INF = 1e30


class Telemetry(NamedTuple):
    """In-loop telemetry of L lanes, the ``tm`` leaf of
    ``engine.EngState``.  Every leaf has a zero-size axis when telemetry
    is off, so the state's structure does not depend on the flag."""

    first_start: torch.Tensor   # f32[L, n] first begin of the live txn
    wait_from: torch.Tensor     # f32[L, n] open wait episode (INF: none)
    wait_acc: torch.Tensor      # f32[L, n] accumulated wait of the txn
    restarts: torch.Tensor      # int32[L, n] restarts of the live txn
    lat_hist: torch.Tensor      # int32[L, NBINS] commit latency
    wait_hist: torch.Tensor     # int32[L, NBINS] wait of committed txns
    restart_hist: torch.Tensor  # int32[L, RBINS] restarts of committed
    abort_causes: torch.Tensor  # int32[L, len(ABORT_CAUSES)]
    block_causes: torch.Tensor  # int32[L, len(BLOCK_CAUSES)]
    trace: torch.Tensor         # f32[L, trace_len, len(TRACE_CHANNELS)]


def init_telemetry(lanes: int, n: int, trace_len: int = 0,
                   device=None) -> Telemetry:
    """Fresh telemetry of ``lanes`` lanes; ``n = 0`` when telemetry is
    off (every leaf empty)."""
    f32, i32 = torch.float32, torch.int32

    def zeros(width, dtype):
        return torch.zeros((lanes, width), dtype=dtype, device=device)

    on = 1 if n else 0
    trace = torch.zeros((lanes, trace_len * on, len(TRACE_CHANNELS)),
                        dtype=f32, device=device)
    trace[:, :, 0] = -1.0                 # `now` < 0 marks unused rows
    return Telemetry(
        first_start=zeros(n, f32),
        wait_from=torch.full((lanes, n), INF, dtype=f32, device=device),
        wait_acc=zeros(n, f32), restarts=zeros(n, i32),
        lat_hist=zeros(NBINS * on, i32), wait_hist=zeros(NBINS * on, i32),
        restart_hist=zeros(RBINS * on, i32),
        abort_causes=zeros(len(ABORT_CAUSES) * on, i32),
        block_causes=zeros(len(BLOCK_CAUSES) * on, i32),
        trace=trace)


# --------------------------------------------------------------------------
# host-side reductions (numpy)
# --------------------------------------------------------------------------

def value_bin(v) -> np.ndarray:
    """Histogram bin of value(s) ``v`` — the shared binning rule."""
    return np.searchsorted(EDGES, v, side="right")


def bin_values() -> np.ndarray:
    """Representative value per bin: the geometric bin centre (the edge
    value at the extremes)."""
    rep = np.empty(NBINS)
    rep[0] = EDGES[0]
    rep[1:-1] = np.sqrt(EDGES[:-1] * EDGES[1:])
    rep[-1] = EDGES[-1]
    return rep


def percentile_from_hist(hist, q: float) -> float:
    """q-quantile (0 < q <= 1) of a histogram over ``EDGES``: the
    representative value of the first bin whose cumulative count
    reaches q."""
    hist = np.asarray(hist)
    total = int(hist.sum())
    if total == 0:
        return float("nan")
    idx = int(np.searchsorted(np.cumsum(hist), q * total))
    return float(bin_values()[min(idx, NBINS - 1)])


def percentiles(hist, qs: Sequence[float] = (0.5, 0.99, 0.999)) -> dict:
    # 0.5 -> p50, 0.99 -> p99, 0.999 -> p999
    def label(q):
        digits = f"{q:g}"[2:]
        return "p" + (digits + "0" if len(digits) == 1 else digits)

    return {label(q): percentile_from_hist(hist, q) for q in qs}


class HostHist:
    """Host-side accumulator over the engine's bins."""

    def __init__(self):
        self.hist = np.zeros(NBINS, np.int64)

    def add(self, v: float) -> None:
        self.hist[int(value_bin(v))] += 1

    def percentiles(self, qs=(0.5, 0.99, 0.999)) -> dict:
        return percentiles(self.hist, qs)

    @property
    def count(self) -> int:
        return int(self.hist.sum())


def summarize(tm: dict) -> dict:
    """Summarise one telemetry block (``lat_hist``/``wait_hist``/
    ``restart_hist``/``abort_causes``/``block_causes`` arrays; leading
    lane axes are summed)."""
    def flat(key, width):
        return np.asarray(tm[key]).reshape(-1, width).sum(axis=0)

    lat = flat("lat_hist", NBINS)
    wait = flat("wait_hist", NBINS)
    restarts = flat("restart_hist", RBINS)
    causes = flat("abort_causes", len(ABORT_CAUSES))
    blocks = flat("block_causes", len(BLOCK_CAUSES))
    n_commit = int(lat.sum())
    return {
        "commits": n_commit,
        "commit_latency": percentiles(lat),
        "wait_time": percentiles(wait),
        "restarts_mean": (float((restarts
                                 * np.arange(RBINS)).sum() / n_commit)
                          if n_commit else float("nan")),
        "abort_causes": {c: int(v) for c, v in zip(ABORT_CAUSES, causes)},
        "block_causes": {c: int(v) for c, v in zip(BLOCK_CAUSES, blocks)},
    }
