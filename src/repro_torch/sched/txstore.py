"""Transactional page store: PPCC-scheduled concurrent updates to shared
pages — the port of ``repro/sched/txstore.py``.

The store holds ``pages`` as one ``[n_pages, page_size]`` tensor.  Per
tick the scheduler (``sched.scheduler``) admits a serializable subset of
the submitted transactions, every admitted transaction reads the
pre-tick pages (writes land at commit, after every read), and the
admitted writes apply in commit order: ``pages[w] += payload[w]`` for an
additive transaction, ``pages[w] = payload[w]`` otherwise.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import scheduler


class TxBatch(NamedTuple):
    read_sets: torch.Tensor     # bool[n, n_pages]
    write_sets: torch.Tensor    # bool[n, n_pages]
    payload: torch.Tensor       # f32[n, n_pages, page] (sparse-by-mask)
    additive: torch.Tensor      # bool[n]  (+= vs =)
    valid: torch.Tensor         # bool[n]


class TickStats(NamedTuple):
    admitted: torch.Tensor
    aborted: torch.Tensor
    n_admitted: torch.Tensor


def apply_tick(pages: torch.Tensor, batch: TxBatch, policy: str = "ppcc"
               ) -> Tuple[torch.Tensor, torch.Tensor, TickStats]:
    """One scheduling tick: ``(new_pages, reads[n, n_pages, page],
    stats)``, the reads a snapshot of the pre-tick pages for the admitted
    readers.

    The writes fold in commit order as a loop over all n transactions:
    float adds must follow that order to match the reference bit for
    bit.  A non-admitted transaction's step changes nothing.  The loop
    reads the order to the host once and issues five launches per
    transaction."""
    res = scheduler.tick(batch.read_sets, batch.write_sets, batch.valid,
                         policy=policy)
    admitted = res.admitted
    read_mask = batch.read_sets & admitted[:, None]
    reads = torch.where(read_mask[:, :, None], pages[None], 0.0)
    order = torch.argsort(torch.where(res.commit_rank < 0, 2 ** 30,
                                      res.commit_rank), stable=True)
    for idx in order.tolist():
        w = batch.write_sets[idx] & admitted[idx]
        pay = batch.payload[idx]
        upd = torch.where(batch.additive[idx], pages + pay, pay)
        pages = torch.where(w[:, None], upd, pages)
    stats = TickStats(admitted=admitted, aborted=res.aborted,
                      n_admitted=admitted.sum(dtype=torch.int32))
    return pages, reads, stats
