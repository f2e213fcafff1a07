"""ACL-style workload generation (paper Section 3.1) — the port's numpy
copy of ``repro/core/workload.py``.

Each transaction is a randomized sequence of read and write operations.
Writes are always performed on items that have already been read in the
same transaction (the paper's strict-protocol assumption); with write
probability 0.5 every read is eventually paired with a write of the same
item, matching the paper's description of the w=0.5 setting.
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np

from .types import Op, OpKind, SimParams


@functools.lru_cache(maxsize=64)
def _zipf_cdf(db_size: int, theta: float) -> np.ndarray:
    """CDF over item ranks for Zipf(theta) hot-spot skew (rank r gets
    weight (r+1)^-theta; item ids double as ranks, so low ids are hot)."""
    w = (np.arange(db_size, dtype=np.float64) + 1.0) ** (-theta)
    return np.cumsum(w) / w.sum()


def _draw_item(rng: np.random.Generator, p: SimParams) -> int:
    """One read-item draw: uniform, or remapped through the Zipf CDF
    when ``p.zipf_theta`` is set.  The uniform draw itself is kept (the
    remap is a sampler-only inverse-CDF transform), so theta == 0 is
    bit-identical to the legacy stream — the same invariant the engine's
    samplers keep (``engine._zipf_map``)."""
    item = int(rng.integers(p.db_size))
    theta = getattr(p, "zipf_theta", 0.0)
    if theta:
        cdf = _zipf_cdf(p.db_size, theta)
        u = item / p.db_size
        item = min(int(np.searchsorted(cdf, u, side="right")),
                   p.db_size - 1)
    return item


def sample_txn_ops(rng: np.random.Generator, p: SimParams) -> List[Op]:
    """Sample one transaction's operation list.

    * length L ~ uniform[mean - spread, mean + spread], at least 2
    * each op: with prob `write_prob` a WRITE of a previously-read,
      not-yet-written item (if none is available it degrades to a READ —
      e.g. the very first op is always a READ);
      otherwise a READ of a uniformly drawn item not read before.
    """
    lo = max(2, p.txn_size_mean - p.txn_size_spread)
    hi = p.txn_size_mean + p.txn_size_spread
    length = int(rng.integers(lo, hi + 1))
    ops: List[Op] = []
    read_items: List[int] = []
    written: set = set()
    for _ in range(length):
        want_write = rng.random() < p.write_prob
        avail = [x for x in read_items if x not in written]
        if want_write and avail:
            item = avail[int(rng.integers(len(avail)))]
            written.add(item)
            ops.append(Op(OpKind.WRITE, item))
        else:
            # Draw an unread item (retry loop is fine: db >> txn size).
            for _ in range(64):
                item = _draw_item(rng, p)
                if item not in read_items:
                    break
            read_items.append(item)
            ops.append(Op(OpKind.READ, item))
    return ops


def cpu_burst(rng: np.random.Generator, p: SimParams) -> float:
    return float(rng.uniform(p.cpu_burst_mean - p.cpu_burst_spread,
                             p.cpu_burst_mean + p.cpu_burst_spread))


def io_time(rng: np.random.Generator, p: SimParams) -> float:
    return float(rng.uniform(p.io_time_mean - p.io_time_spread,
                             p.io_time_mean + p.io_time_spread))


def restart_delay(rng: np.random.Generator, p: SimParams) -> float:
    m = p.restart_delay_mean
    return float(rng.uniform(0.5 * m, 1.5 * m))


def sample_txn_tensor(
    rng: np.random.Generator, p: SimParams, max_ops: int,
    quantum: int = None,
) -> "tuple[np.ndarray, np.ndarray, int]":
    """Tensorised transaction for the engine.

    Returns (kinds[W] int8, items[W] int32, length) with ``W = max_ops``,
    or ``max_ops`` rounded up to ``quantum`` (``bitset.bucket``, the
    same quantiser as the slot/item-word/op axes, DESIGN.md §2.4) so
    host-side batches drop straight into grid-bucket-shaped arrays.
    Slots past `length` are padded with kind=-1 — the engine's inert-op
    convention, so pad width never changes results.
    """
    if quantum is not None:
        from .bitset import bucket
        max_ops = bucket(max_ops, quantum)
    ops = sample_txn_ops(rng, p)
    kinds = np.full((max_ops,), -1, np.int8)
    items = np.zeros((max_ops,), np.int32)
    n = min(len(ops), max_ops)
    for i, op in enumerate(ops[:n]):
        kinds[i] = int(op.kind)
        items[i] = op.item
    return kinds, items, n


def workload_batch(
    seed: int, p: SimParams, n_txns: int, max_ops: int,
    quantum: int = None,
) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """A batch of tensorised transactions: kinds[N,W], items[N,W],
    lengths[N] (``W`` as in ``sample_txn_tensor``)."""
    rng = np.random.default_rng(seed)
    k0, i0, n0 = sample_txn_tensor(rng, p, max_ops, quantum)
    kinds = np.empty((n_txns,) + k0.shape, np.int8)
    items = np.empty((n_txns,) + i0.shape, np.int32)
    lens = np.empty((n_txns,), np.int32)
    kinds[0], items[0], lens[0] = k0, i0, n0
    for t in range(1, n_txns):
        kinds[t], items[t], lens[t] = sample_txn_tensor(rng, p, max_ops,
                                                        quantum)
    return kinds, items, lens
