"""PPCC batch scheduler — the port of ``repro/sched/scheduler.py``.

Per tick the scheduler takes the pending transactions' read and write
sets and decides, under a policy, which may proceed and in which commit
order:

* ``ppcc`` — the Prudent Precedence Rule in priority (or ascending
  conflict-degree) order; conflicting but admissible transactions
  proceed with a precedence that the commit order respects.
* ``2pl``  — a transaction is admitted only if it conflicts with no
  earlier-admitted one.
* ``occ``  — everything runs; a transaction aborts if it read or wrote
  what an earlier survivor wrote.

The pairwise relations come from the conflict kernel
(``kernels.conflict``) and each policy's admission walk from its scan
kernel (``kernels.admit``), one launch each per tick; CPU tensors take
their plain versions (``kernels.ref``).  The tensors' device alone picks
the route through ``tick``; the policy ticks keep the reference's
``use_kernel`` option.

Set inputs are ``bool[n, d]`` masks or packed ``int32[n, W]`` words
(``core.bitset``; the reference's ``uint32`` words, same bits).
``words=`` pads to a word bucket; pad words are zero, so every relation
is unchanged.  Counts and ranks are int32, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import bitset
from ..core import ppcc
from ..device import resolve
from ..kernels import ops as kops
from ..kernels import ref as kref


def _as_bits(sets: torch.Tensor, words: int = None) -> torch.Tensor:
    """Accept ``bool[n, d]`` masks or pre-packed ``int32[n, W]`` rows;
    ``words`` pads the packed rows with zero words to a bucket."""
    bits = sets if sets.dtype == torch.int32 else bitset.pack(sets)
    if words is not None:
        have = bits.shape[-1]
        if words < have:
            raise ValueError(
                f"words={words} below the input's {have} packed words")
        if words > have:
            bits = torch.nn.functional.pad(bits, (0, words - have))
    return bits.contiguous()


class TickResult(NamedTuple):
    admitted: torch.Tensor      # bool[n]
    aborted: torch.Tensor       # bool[n]  (occ validation failures)
    commit_rank: torch.Tensor   # int32[n] commit order among admitted (-1)
    state: ppcc.PPCCState       # one lane ([1, n, ...]) after the tick


class TickCarry(NamedTuple):
    """Carried pairwise state for back-to-back ticks: the previous tick's
    packed words and valid mask, and its ``conflict_fused_full`` 7-tuple.
    A tick whose words and valid mask equal the carried ones reuses the
    7-tuple and launches nothing."""
    read_bits: torch.Tensor     # int32[n, W]
    write_bits: torch.Tensor    # int32[n, W]
    valid: torch.Tensor         # bool[n]
    rel: Tuple[torch.Tensor, ...]


def carry_from_numpy(read_bits, write_bits, valid, rel,
                     device=None) -> TickCarry:
    """A port ``TickCarry`` from the reference's, given as numpy arrays
    (``np.asarray`` of each leaf), on ``device`` (the card unless the
    caller asks for the CPU): ``uint32`` words are viewed as ``int32``,
    so a port tick can resume from a reference tick."""
    dev = resolve(device)

    def t(a):
        a = np.array(a)                 # a writable copy
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(dev)
    return TickCarry(read_bits=t(read_bits), write_bits=t(write_bits),
                     valid=t(valid), rel=tuple(t(r) for r in rel))


def _conflict_matrices(read_bits, write_bits, use_kernel: bool):
    """``(raw, ww, raw_deg, ww_deg)``: ``raw[i, j]`` i reads what j
    writes, ``ww[i, j]`` write sets overlap, int32 row degrees counting
    the diagonal — one fused launch."""
    if use_kernel:
        return kops.conflict_fused(read_bits, write_bits)
    return kref.conflict_fused_ref(read_bits, write_bits)


def _unchanged(carry: TickCarry, rb, wb, valid) -> bool:
    """Whether a tick's inputs equal the carried ones.  One host read per
    tick that passes a carry: the launch it may skip is the O(n^2 W)
    conflict pass, so a sync is cheap beside it."""
    if (carry.read_bits.shape != rb.shape
            or carry.write_bits.shape != wb.shape
            or carry.valid.shape != valid.shape):
        return False
    same = (torch.eq(carry.read_bits, rb).all()
            & torch.eq(carry.write_bits, wb).all()
            & torch.eq(carry.valid, valid).all())
    return bool(same)


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def degree_order(full) -> torch.Tensor:
    """``int32[n]``: the transactions in ascending conflict degree, ties
    by index, from a ``conflict_fused_full`` 7-tuple.  The degree is RAW
    out + WAR in + WW; the kernel's degrees count the diagonal, and
    self-conflicts are not conflicts here, so it is stripped."""
    _, _, raw_deg, war_deg, ww_deg, diag_raw, diag_ww = full
    self_r = diag_raw.to(torch.int32)
    deg = (raw_deg - self_r + war_deg - self_r
           + ww_deg - diag_ww.to(torch.int32))
    return torch.argsort(deg, stable=True).to(torch.int32)


def ppcc_tick(read_sets, write_sets, valid, use_kernel: bool = True,
              order: str = "priority", words: int = None,
              carry: TickCarry = None, return_carry: bool = False):
    """Admit a batch of single-shot transactions under PPCC.

    With the relations precomputed, the Prudent Precedence Rule for
    transaction i against the admitted set is

      R_i = {admitted j : read_i  cap write_j}   (arcs i -> j)
      W_i = {admitted k : write_i cap read_k}    (arcs k -> i)
      admit iff no j in R_i is preceding, no k in W_i is preceded, and
      not both R_i and W_i are nonempty.

    WAW alone imposes no precedence; the commit order puts the
    preceding class first.  ``order="degree"`` admits in ascending
    conflict degree (RAW out + WAR in + WW, the diagonal stripped),
    ties by index.  ``carry`` skips the conflict launch when the words
    and valid mask are unchanged; ``return_carry=True`` returns
    ``(TickResult, TickCarry)``.
    """
    n = read_sets.shape[0]
    rb = _as_bits(read_sets, words)
    wb = _as_bits(write_sets, words)
    dev = rb.device
    full = None
    if order == "degree" or carry is not None or return_carry:
        if carry is not None and _unchanged(carry, rb, wb, valid):
            full = carry.rel
        elif use_kernel:
            full = kops.conflict_fused_full(rb, wb)
        else:
            full = kref.conflict_fused_full_ref(rb, wb)
        raw = full[0]
    if order == "degree":
        seq = degree_order(full)
    else:
        if full is None:
            raw = _conflict_matrices(rb, wb, use_kernel)[0]
        seq = torch.arange(n, dtype=torch.int32, device=dev)
    raw = raw & ~_eye(n, dev)                  # self-RAW is not a conflict
    admit = kops.ppcc_admit if use_kernel else kref.ppcc_admit_ref
    admitted, preceding, preceded, prec = admit(raw, valid.contiguous(),
                                                seq)
    # commit order: preceding class (readers) first
    rank_key = torch.where(admitted, preceded.to(torch.int32), 2 ** 30)
    commit_order = torch.argsort(rank_key, stable=True)
    commit_rank = torch.full((n,), -1, dtype=torch.int32, device=dev)
    commit_rank[commit_order] = torch.arange(n, dtype=torch.int32,
                                             device=dev)
    commit_rank = torch.where(admitted, commit_rank, -1)
    s = ppcc.init_state(1, n, 1, device=dev)
    s = s._replace(prec=prec[None], preceding=preceding[None],
                   preceded=preceded[None], active=admitted[None])
    res = TickResult(admitted=admitted, aborted=torch.zeros_like(admitted),
                     commit_rank=commit_rank, state=s)
    if return_carry:
        return res, TickCarry(read_bits=rb, write_bits=wb, valid=valid,
                              rel=tuple(full))
    return res


def _rank(admitted: torch.Tensor) -> torch.Tensor:
    """Commit rank in index order among the admitted, -1 elsewhere."""
    return torch.where(admitted, admitted.cumsum(0, dtype=torch.int32) - 1,
                       -1)


def twopl_tick(read_sets, write_sets, valid, use_kernel: bool = True,
               words: int = None) -> TickResult:
    """Conservative baseline: admit a prefix-greedy conflict-free set."""
    rb = _as_bits(read_sets, words)
    wb = _as_bits(write_sets, words)
    raw, ww, *_ = _conflict_matrices(rb, wb, use_kernel)
    admit = kops.twopl_admit if use_kernel else kref.twopl_admit_ref
    admitted = admit(raw, ww, valid.contiguous())
    return TickResult(admitted=admitted, aborted=torch.zeros_like(admitted),
                      commit_rank=_rank(admitted),
                      state=ppcc.init_state(1, 1, 1, device=rb.device))


def occ_tick(read_sets, write_sets, valid, use_kernel: bool = True,
             words: int = None) -> TickResult:
    """Optimistic baseline: all run; backward validation in priority
    order — abort if an earlier survivor wrote what you read or wrote."""
    rb = _as_bits(read_sets, words)
    wb = _as_bits(write_sets, words)
    raw, ww, *_ = _conflict_matrices(rb, wb, use_kernel)
    admit = kops.occ_admit if use_kernel else kref.occ_admit_ref
    survivors = admit(raw, ww, valid.contiguous())
    return TickResult(admitted=survivors, aborted=valid & ~survivors,
                      commit_rank=_rank(survivors),
                      state=ppcc.init_state(1, 1, 1, device=rb.device))


POLICIES = {"ppcc": ppcc_tick, "2pl": twopl_tick, "occ": occ_tick}


def tick_stats(read_sets, write_sets, valid, result: TickResult,
               use_kernel: bool = True, words: int = None) -> dict:
    """Host-side per-tick telemetry: admitted/aborted/pending counts and
    the degree of the symmetric conflict relation ``raw | raw^T | ww``
    over the valid batch (max and mean).  Reads the tick, mutates
    nothing; it waits for the card."""
    rb = _as_bits(read_sets, words)
    wb = _as_bits(write_sets, words)
    raw, ww, *_ = _conflict_matrices(rb, wb, use_kernel)
    n = rb.shape[0]
    conflict = (raw | raw.T | ww) & ~_eye(n, rb.device)
    conflict = conflict & valid[None, :] & valid[:, None]
    deg = conflict.sum(1, dtype=torch.int32)[valid].cpu().numpy()
    admitted = int(result.admitted.sum())
    aborted = int(result.aborted.sum())
    n_valid = int(valid.sum())
    return {
        "valid": n_valid,
        "admitted": admitted,
        "aborted": aborted,
        "pending": n_valid - admitted - aborted,
        "degree_max": int(deg.max()) if deg.size else 0,
        "degree_mean": float(deg.mean()) if deg.size else 0.0,
    }


def tick(read_sets, write_sets, valid, policy: str = "ppcc",
         order: str = "priority", words: int = None, carry: TickCarry = None,
         return_carry: bool = False):
    """One admission tick.  For ppcc, ``carry``/``return_carry`` thread
    the pairwise state across ticks (see ``TickCarry``).  The tensors'
    device decides where the tick runs: the kernels on the card, their
    plain versions on the CPU."""
    if policy == "ppcc":
        return ppcc_tick(read_sets, write_sets, valid, order=order,
                         words=words, carry=carry, return_carry=return_carry)
    if order != "priority":
        raise ValueError(
            f"order={order!r} is only supported for policy='ppcc'")
    if carry is not None or return_carry:
        raise ValueError("carried conflict state is ppcc-only")
    return POLICIES[policy](read_sets, write_sets, valid, words=words)

