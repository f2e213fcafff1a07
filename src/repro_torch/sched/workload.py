"""YCSB-style transaction batches for the batch scheduler, made by numpy
from a seed, and the digests that hold two runs of it equal.

The full-width batch is the scheduler's design point
(``repro/kernels/conflict.py``: thousands of concurrent transactions,
W <= 1024 words): n = 4,096 pending transactions over d = 32,768 pages.
Each transaction touches 16 distinct pages (DBx1000's YCSB request
count), reads every one and writes each with probability 0.5 (YCSB
workload A's read/update mix), drawn Zipfian with theta = 0.8 (the
high-contention setting of Yu et al., "Staring into the Abyss", VLDB
2014).  Page ``k`` is Zipf rank ``k + 1``.

The generator is numpy and the standard library, so the same seed gives
the same arrays wherever it runs; ``digest`` lets a run prove that
before it compares results.  ``drain`` is the serving loop that the
golden and ``chip_smoke.py`` run over the batch, in the ``MODES``.  The Zipf weights come from ``math.pow`` and a
sequential float64 sum, not from numpy's vectorised ``power``, whose SIMD
paths may round differently on another CPU.
"""
from __future__ import annotations

import hashlib
import itertools
import math

import numpy as np
import torch

from . import scheduler

N_TXN = 4096
N_PAGES = 32768
PER_TXN = 16
THETA = 0.8
P_WRITE = 0.5
SEED = 0
TICKS = 8                # ticks of the drain loop per mode
# the page store's batch: n = 512 transactions over 4,096 pages of 32
# float32 values (payload and snapshot reads 268 MB each)
STORE_TXN = 512
STORE_PAGES = 4096
STORE_PAGE = 32
STORE_SEED = 1


def zipf_cdf(d: int, theta: float) -> np.ndarray:
    """float64[d]: P(rank <= k + 1) of a Zipf(theta) law over d ranks,
    the last entry exactly 1."""
    w = [math.pow(r, -theta) for r in range(1, d + 1)]
    acc = list(itertools.accumulate(w))
    cdf = np.array(acc, dtype=np.float64) / acc[-1]
    cdf[-1] = 1.0
    return cdf


def ycsb_pages(rng: np.random.Generator, n: int, d: int,
               per_txn: int = PER_TXN, theta: float = THETA) -> np.ndarray:
    """int64[n, per_txn]: each row ``per_txn`` distinct Zipf pages, in the
    order drawn (repeats are skipped, as a YCSB client redraws them)."""
    if per_txn > d:
        raise ValueError(f"{per_txn} distinct pages of {d}")
    cdf = zipf_cdf(d, theta)
    cand = np.searchsorted(cdf, rng.random((n, 4 * per_txn)), side="right")
    out = np.empty((n, per_txn), dtype=np.int64)
    for i in range(n):
        seen: list = []
        row = cand[i].tolist()
        while len(seen) < per_txn:
            if not row:
                row = np.searchsorted(cdf, rng.random(4 * per_txn),
                                      side="right").tolist()
            p = row.pop(0)
            if p not in seen:
                seen.append(p)
        out[i] = seen
    return out


def masks(pages: np.ndarray, write: np.ndarray, d: int):
    """(read bool[n, d], write bool[n, d]) from page lists and write
    flags: every listed page is read, the flagged ones are written."""
    n = pages.shape[0]
    rows = np.repeat(np.arange(n), pages.shape[1])
    read = np.zeros((n, d), dtype=bool)
    read[rows, pages.reshape(-1)] = True
    wr = np.zeros((n, d), dtype=bool)
    wr[rows[write.reshape(-1)], pages.reshape(-1)[write.reshape(-1)]] = True
    return read, wr


def pack_words(sets: np.ndarray) -> np.ndarray:
    """bool[n, d] -> uint32[n, ceil(d/32)]: item x at bit x & 31 of word
    x >> 5, pad bits zero (the packed layout of both packages)."""
    n, d = sets.shape
    pad = (-d) % 32
    if pad:
        sets = np.pad(sets, ((0, 0), (0, pad)))
    return np.packbits(sets, axis=1, bitorder="little").view("<u4")


def ycsb_batch(n: int = N_TXN, d: int = N_PAGES, seed: int = SEED,
               per_txn: int = PER_TXN, theta: float = THETA,
               p_write: float = P_WRITE):
    """(read_words, write_words), each uint32[n, ceil(d/32)]: the
    scheduler's pending batch."""
    rng = np.random.default_rng(seed)
    pages = ycsb_pages(rng, n, d, per_txn, theta)
    write = rng.random(pages.shape) < p_write
    read, wr = masks(pages, write, d)
    return pack_words(read), pack_words(wr)


def store_batch(n: int = STORE_TXN, d: int = STORE_PAGES,
                page: int = STORE_PAGE, seed: int = STORE_SEED):
    """The page store's tick: ``(pages f32[d, page], read bool[n, d],
    write bool[n, d], payload f32[n, d, page], additive bool[n])``."""
    rng = np.random.default_rng(seed)
    pg = ycsb_pages(rng, n, d)
    write = rng.random(pg.shape) < P_WRITE
    read, wr = masks(pg, write, d)
    additive = rng.random(n) < 0.5
    pages = rng.standard_normal((d, page), dtype=np.float32)
    payload = rng.standard_normal((n, d, page), dtype=np.float32)
    return pages, read, wr, payload, additive


def digest(*arrays) -> str:
    """sha256 over the arrays' bytes in a fixed layout: bool as one byte,
    integers as little-endian int32, floats as little-endian float32."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype == bool:
            a = a.astype(np.uint8)
        elif a.dtype.kind in "iu":
            a = a.astype("<i4")
        else:
            a = a.astype("<f4")
        h.update(a.tobytes())
    return h.hexdigest()


def tick_record(admitted, aborted, commit_rank, stats=None, prec=None,
                preceding=None, preceded=None) -> dict:
    """One tick's result as counts and digests (numpy inputs, ``prec``
    as ``[n, n]``): the form the golden file keeps and a run is held
    to."""
    rec = {"admitted": int(np.sum(admitted)), "aborted": int(np.sum(aborted)),
           "sha256": {"admitted": digest(admitted), "aborted": digest(aborted),
                      "commit_rank": digest(commit_rank)}}
    if prec is not None:
        rec["sha256"].update(prec=digest(prec), preceding=digest(preceding),
                             preceded=digest(preceded))
    if stats is not None:
        rec["stats"] = dict(stats)
    return rec


def store_record(new_pages, reads, admitted, aborted) -> dict:
    """One page-store tick as counts and digests (numpy inputs)."""
    return {"n_admitted": int(np.sum(admitted)),
            "sha256": {"pages": digest(new_pages), "reads": digest(reads),
                       "admitted": digest(admitted),
                       "aborted": digest(aborted)}}


MODES = {"ppcc": ("ppcc", "priority"), "ppcc_degree": ("ppcc", "degree"),
         "2pl": ("2pl", "priority"), "occ": ("occ", "priority")}


def drain(read_sets, write_sets, mode: str = "ppcc", ticks: int = TICKS):
    """The serving loop of ``examples/serve_batch.py`` without the model:
    ``tick`` -> ``tick_stats`` -> ``pending &= ~admitted``, from an
    all-pending batch, for at most ``ticks`` ticks while any transaction
    is pending.  ``mode`` is a key of ``MODES``; ``ppcc_degree`` threads
    the carry and then repeats its last tick with unchanged inputs, which
    the carry serves without a conflict launch.

    Returns ``(steps, repeat)``: ``[(TickResult, stats dict), ...]`` and
    the repeated tick's ``TickResult`` (``None`` in the other modes)."""
    policy, order = MODES[mode]
    degree = order == "degree"
    pending = torch.ones(read_sets.shape[0], dtype=torch.bool,
                         device=read_sets.device)
    steps, carry, valid = [], None, None
    for _ in range(ticks):
        if not bool(pending.any()):
            break
        valid = pending.clone()
        res = scheduler.tick(read_sets, write_sets, valid, policy=policy,
                             order=order, carry=carry, return_carry=degree)
        if degree:
            res, carry = res
        steps.append((res, scheduler.tick_stats(read_sets, write_sets,
                                                valid, res)))
        pending &= ~res.admitted
    repeat = None
    if degree and valid is not None:
        repeat = scheduler.tick(read_sets, write_sets, valid, policy=policy,
                                order=order, carry=carry)
    return steps, repeat
