"""Shared types: the port's own copy of ``repro/core/types.py``.

The paper's simulation model (Section 3.1, after Agrawal-Carey-Livny)
is parameterised by ``SimParams``; ``paper_figure_params`` maps each of
Figs. 5-16 to its setting and ``grid_cover_params`` gives the static
buckets one fleet needs to run them all.  A transaction is a fixed
sequence of ``Op``s (``core.workload``); a write always targets an item
the same transaction read before.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class OpKind(enum.IntEnum):
    READ = 0
    WRITE = 1


@dataclasses.dataclass(frozen=True)
class Op:
    kind: OpKind
    item: int

    def __repr__(self) -> str:  # compact: R(7) / W(3)
        return f"{'RW'[self.kind]}({self.item})"


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Base parameter settings (paper Table 1)."""

    db_size: int = 500                  # 100 or 500 items
    txn_size_mean: int = 8              # 8 +- 4 or 16 +- 4 operations
    txn_size_spread: int = 4
    write_prob: float = 0.2             # 0.2 or 0.5
    num_cpus: int = 4                   # 4/8 or 16/32
    num_disks: int = 8
    cpu_burst_mean: float = 15.0        # 15 +- 5 time units
    cpu_burst_spread: float = 5.0
    io_time_mean: float = 35.0          # 35 +- 10 time units
    io_time_spread: float = 10.0
    mpl: int = 25                       # multiprogramming level (closed loop)
    horizon: float = 100_000.0          # simulation length, time units
    block_timeout: float = 400.0        # block quantum before abort
    restart_delay_mean: float = 25.0    # delay before an aborted txn restarts
    seed: int = 0
    zipf_theta: float = 0.0             # hot-spot read skew; 0 keeps the
                                        # paper's uniform model

    def with_(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SimResult:
    """Primary metric is ``commits`` within the horizon (paper Section
    3.2)."""

    protocol: str
    params: SimParams
    commits: int = 0
    aborts: int = 0
    blocks: int = 0
    restarts: int = 0
    ops_executed: int = 0
    sum_response_time: float = 0.0
    sim_time: float = 0.0
    telemetry: Optional[dict] = None

    @property
    def throughput(self) -> float:
        return float(self.commits)

    @property
    def mean_response(self) -> float:
        return self.sum_response_time / max(self.commits, 1)

    def row(self) -> Tuple:
        p = self.params
        return (self.protocol, p.mpl, self.commits, self.aborts,
                self.restarts, round(self.mean_response, 1))


_FIGURES = {
    # fig: (write_prob, txn_size, db_size, cpus, disks)
    5:  (0.2, 8, 500, 4, 8),
    6:  (0.2, 8, 100, 4, 8),
    7:  (0.2, 16, 500, 4, 8),
    8:  (0.2, 16, 100, 4, 8),
    9:  (0.5, 8, 500, 4, 8),
    10: (0.5, 8, 100, 4, 8),
    11: (0.5, 16, 500, 4, 8),
    12: (0.5, 16, 100, 4, 8),
    13: (0.2, 8, 500, 16, 32),
    14: (0.2, 8, 100, 16, 32),
    15: (0.5, 8, 500, 16, 32),
    16: (0.5, 8, 100, 16, 32),
}


def paper_figure_params(fig: int) -> Optional[SimParams]:
    """Map paper figure number (5..16) to its parameter setting."""
    if fig not in _FIGURES:
        return None
    w, ts, db, c, d = _FIGURES[fig]
    return SimParams(write_prob=w, txn_size_mean=ts, db_size=db,
                     num_cpus=c, num_disks=d)


GRID_FIGS = tuple(range(5, 17))


def grid_cover_params(figs=GRID_FIGS) -> SimParams:
    """Smallest ``SimParams`` whose static buckets cover every figure:
    max db_size / txn size / resource counts over ``figs``, so one
    fleet runs any of them with the per-figure values supplied as
    runtime scalars (``engine.RtParams``)."""
    ps = []
    for f in figs:
        p = paper_figure_params(f)
        if p is None:
            raise ValueError(f"unknown paper figure: {f}")
        ps.append(p)
    return SimParams(
        db_size=max(p.db_size for p in ps),
        txn_size_mean=max(p.txn_size_mean for p in ps),
        txn_size_spread=max(p.txn_size_spread for p in ps),
        write_prob=ps[0].write_prob,
        num_cpus=max(p.num_cpus for p in ps),
        num_disks=max(p.num_disks for p in ps))


# Peak throughputs reported in the paper: fig -> (ppcc, 2pl, occ)
PAPER_PEAKS = {
    5:  (2271, 2189, 1733),
    6:  (1625, 1456, 1121),
    7:  (866, 789, 597),
    8:  (394, 331, 297),
    9:  (2301, 2259, 1825),
    10: (1553, 1506, 1148),
    11: (796, 780, 562),
    12: (343, 303, 283),
    13: (6793, 6287, 4650),
    14: (2936, 2400, 2413),
    15: (6659, 6267, 4818),
    16: (2784, 2227, 2459),
}
