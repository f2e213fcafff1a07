"""Prudent-Precedence protocol state and the batched cohort primitives —
the port of the parts of ``repro/core/ppcc.py`` that the fused fleet
body and the Theorem-1 checks use.

Every tensor carries a leading lane axis: set rows are ``int32[L, n, W]``
packed words (``core.bitset``), the precedence graph is ``bool[L, n, n]``
and per-slot flags are ``bool[L, n]``.  A single lane is ``L = 1``.

Wait-to-commit lock ownership is derived, as in the reference: a slot
with ``haslocks[l, k]`` holds exclusive locks on exactly its
``write_set[l, k]`` items.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import bitset as B
from ..device import resolve
from ..kernels import ref as kref

# verdicts
PROCEED, BLOCK, ABORT = 0, 1, 2

# block-reason codes attached to BLOCK verdicts
R_NONE, R_LOCK, R_RULE = 0, 1, 2


class PPCCState(NamedTuple):
    """Protocol state for L lanes of n transaction slots over d items."""

    read_set: torch.Tensor   # int32[L, n, W] packed bitset
    write_set: torch.Tensor  # int32[L, n, W] (private-workspace writes)
    prec: torch.Tensor       # bool[L, n, n]  prec[l, a, b]: a -> b
    preceding: torch.Tensor  # bool[L, n]     class bit: has preceded someone
    preceded: torch.Tensor   # bool[L, n]     class bit: has been preceded
    active: torch.Tensor     # bool[L, n]     slot holds a live transaction
    haslocks: torch.Tensor   # bool[L, n]     holds wait-to-commit locks on
                             #                its whole write_set row

    @property
    def lanes(self) -> int:
        return self.read_set.shape[0]

    @property
    def n(self) -> int:
        return self.read_set.shape[1]

    @property
    def words(self) -> int:
        return self.read_set.shape[2]


def init_state(lanes: int, n: int, d: int, device=None) -> PPCCState:
    """Empty protocol state on ``device`` (the card unless the caller
    asks for the CPU)."""
    device = resolve(device)
    flags = torch.zeros((lanes, n), dtype=torch.bool, device=device)
    return PPCCState(
        read_set=B.zeros(lanes, n, d, device=device),
        write_set=B.zeros(lanes, n, d, device=device),
        prec=torch.zeros((lanes, n, n), dtype=torch.bool, device=device),
        preceding=flags, preceded=flags.clone(), active=flags.clone(),
        haslocks=flags.clone())


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def begin_many(s: PPCCState, mask: torch.Tensor) -> PPCCState:
    """Activate every masked slot (``bool[L, n]``) as a fresh independent
    transaction; begins touch only slot-local rows and columns, so any
    set of them commutes."""
    m = mask
    return s._replace(
        read_set=B.clear_rows(s.read_set, m),
        write_set=B.clear_rows(s.write_set, m),
        prec=s.prec & ~m[:, :, None] & ~m[:, None, :],
        preceding=s.preceding & ~m,
        preceded=s.preceded & ~m,
        active=s.active | m,
        haslocks=s.haslocks & ~m,
    )


def begin(s: PPCCState, i: torch.Tensor) -> PPCCState:
    """Activate slot ``i[l]`` of every lane."""
    slots = torch.arange(s.n, device=i.device)
    return begin_many(s, slots[None, :] == i[:, None])


def _op_tables(s: PPCCState, item: torch.Tensor):
    """(writers_at, readers_at), each ``[l, i, k]`` =
    ``{write,read}_set[l, k, item[l, i]]``."""
    return B.item_cols(s.write_set, item), B.item_cols(s.read_set, item)


def _parties(s: PPCCState, is_write, writers_at, readers_at):
    """party[l, i, k]: slot i's pending op touches slot k's state."""
    eye = _eye(s.n, s.active.device)
    others = torch.where(is_write[:, :, None], readers_at, writers_at)
    return (others & s.active[:, None, :] & ~eye) | eye


def _any_overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[L, N, M] x bool[L, K, M] -> bool[L, N, K] row-pair
    intersection via packed words (self-joins pack once)."""
    ap = B.pack(a)
    bp = ap if b is a else B.pack(b)
    return B.any_overlap(ap, bp)


def _dep_matrix(s: PPCCState, item, is_write, writers_at, readers_at):
    """dep[l, i, j]: ops of slots i and j do not commute — their parties
    intersect, or they target the same item with a write involved."""
    party = _parties(s, is_write, writers_at, readers_at)
    dep = _any_overlap(party, party)
    same_item = item[:, :, None] == item[:, None, :]
    either_write = is_write[:, :, None] | is_write[:, None, :]
    return (dep | (same_item & either_write)) & ~_eye(s.n, item.device)


def _try_ops(s: PPCCState, item, is_write, mask, writers_at, readers_at):
    """One protocol op per masked slot against the pre-state (the masked
    ops must be pairwise independent).  Returns (state, verdict int32,
    block-reason int32)."""
    eye = _eye(s.n, item.device)
    prec_t = s.prec.transpose(1, 2)

    owner_at = writers_at & s.haslocks[:, None, :]
    locked_by_other = (owner_at & ~eye).any(2)
    i_prec_owner = (owner_at & s.prec).any(2)
    lock_v = torch.where(
        locked_by_other,
        torch.where(i_prec_owner, ABORT, BLOCK),
        torch.full_like(item, PROCEED))

    act = s.active[:, None, :]
    new_writers = writers_at & act & ~eye & ~s.prec     # read: ~prec[i, k]
    new_readers = readers_at & act & ~eye & ~prec_t     # write: ~prec[k, i]

    any_new_r = new_writers.any(2)
    rule_r = ~s.preceded & ~(new_writers & s.preceding[:, None, :]).any(2)
    any_new_w = new_readers.any(2)
    rule_w = ~s.preceding & ~(new_readers & s.preceded[:, None, :]).any(2)

    any_new = torch.where(is_write, any_new_w, any_new_r)
    rule_ok = torch.where(is_write, rule_w, rule_r)
    allowed = (lock_v == PROCEED) & (~any_new | rule_ok) & mask
    verdict = torch.where(lock_v != PROCEED, lock_v,
                          torch.where(allowed, PROCEED, BLOCK))
    verdict = torch.where(mask, verdict, BLOCK).to(torch.int32)
    reason = torch.where(mask & (verdict == BLOCK),
                         torch.where(locked_by_other, R_LOCK, R_RULE),
                         R_NONE).to(torch.int32)

    ok_r = allowed & ~is_write
    ok_w = allowed & is_write
    add_r = new_writers & ok_r[:, :, None]               # arcs i -> k
    add_w = new_readers & ok_w[:, :, None]               # arcs k -> i
    return s._replace(
        read_set=B.or_rowwise(s.read_set, item, ok_r),
        write_set=B.or_rowwise(s.write_set, item, ok_w),
        prec=s.prec | add_r | add_w.transpose(1, 2),
        preceding=s.preceding | (ok_r & any_new_r) | add_w.any(1),
        preceded=s.preceded | (ok_w & any_new_w) | add_r.any(1),
    ), verdict, reason


class FusedStep(NamedTuple):
    """Result of one fused cohort step (``cohort_step_fused``)."""

    state: PPCCState
    verdict: torch.Tensor    # int32[L, n] read-phase verdicts
    selected: torch.Tensor   # bool[L, n]  pairwise-independent admitted set
    degree: torch.Tensor     # int32[L, n] conflict degree among ready ops
    won: torch.Tensor        # bool[L, n]  wait-to-commit lock winners
    can_commit: torch.Tensor  # bool[L, n] Fig. 4 test on the post-ops state
    reason: torch.Tensor     # int32[L, n] block-reason codes


class Relations(NamedTuple):
    """The four pairwise relations of a fused cohort step."""

    dep: torch.Tensor         # bool[L, n, n] op dependence, diagonal False
    ww: torch.Tensor          # bool[L, n, n] write-write overlap, diag False
    writers_at: torch.Tensor  # bool[L, n, n] [l, i, k] = item_i in write_set[k]
    readers_at: torch.Tensor  # bool[L, n, n] [l, i, k] = item_i in read_set[k]


def compute_relations(s: PPCCState, item: torch.Tensor,
                      is_write: torch.Tensor) -> Relations:
    """Full recompute of the four relations — the inline twin of the
    megakernel's first four outputs."""
    writers_at, readers_at = _op_tables(s, item)
    dep = _dep_matrix(s, item, is_write, writers_at, readers_at)
    ww = B.any_overlap(s.write_set, s.write_set) & \
        ~_eye(s.n, item.device)
    return Relations(dep, ww, writers_at, readers_at)


def relations_inputs(rel: Relations, ready: torch.Tensor,
                     haslocks: torch.Tensor):
    """Attach the per-quantum ``deg``/``lockhit`` vectors: the 6-tuple
    ``cohort_step_fused(relations=...)`` takes."""
    deg = (rel.dep & ready[:, None, :]).sum(2, dtype=torch.int32)
    lockhit = (rel.ww & haslocks[:, None, :]).any(2)
    return (rel.dep, rel.ww, rel.writers_at, rel.readers_at, deg, lockhit)


# --------------------------------------------------------------------------
# delta-maintained relations: the engine carries the four relations across
# iterations and recomputes only the dirty rows (then mirrors the
# symmetric dep/ww rows into their columns)
# --------------------------------------------------------------------------

def empty_relations(lanes: int, n: int = 0, device=None) -> Relations:
    """``[L, n, n]`` all-False relations; ``n = 0`` when the delta path
    is off (keeps the engine state's structure constant)."""
    z = torch.zeros((lanes, n, n), dtype=torch.bool, device=device)
    return Relations(z, z, z, z)


def dirty_slots(old: PPCCState, new: PPCCState, old_item: torch.Tensor,
                new_item: torch.Tensor, old_isw: torch.Tensor,
                new_isw: torch.Tensor) -> torch.Tensor:
    """bool[L, n]: slots whose relation rows may differ between the old
    and new (state, op cursor) pairs — a bit of the slot's own words
    changed, its pending (item, kind) changed, or the bit of its item is
    in the union of all slots' word changes (a third slot joined or left
    its party)."""
    delta = (old.read_set ^ new.read_set) | (old.write_set ^ new.write_set)
    rowchange = B.any_bit(delta)
    cursor = (old_item != new_item) | (old_isw != new_isw)
    union = B.or_reduce(delta, axis=1)                   # int32[L, W]
    w, b = B.word_bit(new_item)
    member = ((union.gather(1, w) >> b) & 1).bool()
    return rowchange | cursor | member


def dirty_slab(dirty: torch.Tensor, k: int):
    """Gather each lane's dirty-row ids into a ``k``-slot slab: (slab
    int32[L, k] — ids ascending, padded with n; valid bool[L, k]; count
    int32[L] — the true dirty count, > k on overflow).  Built from cumsum
    positions and a scatter, with no host read."""
    lanes, n = dirty.shape
    pos = torch.cumsum(dirty, 1, dtype=torch.int64) - 1
    # ids past the slab, and clean slots, land in the dropped column k
    at = torch.where(dirty & (pos < k), pos, k)
    ids = torch.arange(n, dtype=torch.int32, device=dirty.device)
    slab = torch.full((lanes, k + 1), n, dtype=torch.int32,
                      device=dirty.device)
    slab = slab.scatter(1, at, ids.expand(lanes, n))[:, :k]
    return slab, slab < n, dirty.sum(1, dtype=torch.int32)


def scatter_relations(rel: Relations, dep_rows: torch.Tensor,
                      ww_rows: torch.Tensor, wat_rows: torch.Tensor,
                      rat_rows: torch.Tensor, slab: torch.Tensor,
                      valid: torch.Tensor) -> Relations:
    """Write a row slab's ``[L, K, n]`` row blocks back into the carried
    ``[L, n, n]`` relations: rows for all four, then the mirrored
    columns of dep/ww (``kernels.ref.scatter_padded_``).  Invalid
    entries are dropped.  The results are views of one padded buffer."""
    buf = kref.padded_tables(rel)
    rows = torch.stack((dep_rows, ww_rows, wat_rows, rat_rows))
    return Relations(*kref.unpadded_tables(
        kref.scatter_padded_(buf, rows, slab, valid)))


def cohort_step_fused(s: PPCCState, item: torch.Tensor,
                      is_write: torch.Tensor, ready: torch.Tensor,
                      wc_mask: torch.Tensor, *, order: str = "index",
                      relations=None) -> FusedStep:
    """One cohort step, fused end to end: relations → ordered
    independence selection → op verdicts + apply → wait-to-commit
    winners (one-step relaxation) → commit test.

    ``ready`` marks read-phase ops and ``wc_mask`` the slots attempting
    wait-to-commit lock acquisition; the engine keeps them disjoint,
    which makes the pre-state write-write join exact for the lock phase.
    ``relations`` optionally supplies the tuple
    ``kernels.ops.megastep_relations`` returns (its trailing
    ``dirty_hit`` is ignored) in place of the inline joins.
    """
    n = s.n
    idx = torch.arange(n, dtype=torch.int32, device=item.device)
    if relations is None:
        rel = compute_relations(s, item, is_write)
        dep, ww, writers_at, readers_at, deg, lockhit = \
            relations_inputs(rel, ready, s.haslocks)
    else:
        dep, ww, writers_at, readers_at, deg, lockhit = relations[:6]
    if order == "index":
        key = idx[None, :].expand(s.lanes, n)
    elif order == "degree":
        key = deg * n + idx          # unique keys: ties broken by slot
    else:
        raise ValueError(f"unknown selection order: {order!r}")
    before = key[:, None, :] < key[:, :, None]
    sel = ready & ~(dep & ready[:, None, :] & before).any(2)
    s2, verdict, reason = _try_ops(s, item, is_write, sel, writers_at,
                                   readers_at)

    feasible = wc_mask & ~lockhit
    lower = idx[None, :] < idx[:, None]
    won = feasible & ~(ww & feasible[:, None, :] & lower).any(2)
    s3 = s2._replace(haslocks=s2.haslocks | won)
    return FusedStep(s3, verdict, sel, deg, won, can_commit_many(s3),
                     reason)


def can_commit_many(s: PPCCState) -> torch.Tensor:
    """Fig. 4 test: slot i may commit iff no active transaction
    precedes it."""
    return ~(s.prec & s.active[:, :, None]).any(1)


def _leave_many(s: PPCCState, mask: torch.Tensor) -> PPCCState:
    return s._replace(
        read_set=B.clear_rows(s.read_set, mask),
        write_set=B.clear_rows(s.write_set, mask),
        prec=s.prec & ~mask[:, :, None] & ~mask[:, None, :],
        active=s.active & ~mask,
        haslocks=s.haslocks & ~mask,
    )


def commit_many(s: PPCCState, mask: torch.Tensor) -> PPCCState:
    """Batched commit: leaves of distinct slots commute."""
    return _leave_many(s, mask)


def abort_many(s: PPCCState, mask: torch.Tensor) -> PPCCState:
    """Batched abort: leaves of distinct slots commute."""
    return _leave_many(s, mask)


# --------------------------------------------------------------------------
# invariants (paper Theorem 1), one verdict per lane
# --------------------------------------------------------------------------

def path_length_leq_one(s: PPCCState) -> torch.Tensor:
    """bool[L]: no precedence path of length 2 (``prec @ prec == 0``).
    The product runs in float32, exact for counts below 2**24."""
    p = s.prec.to(torch.float32)
    return torch.bmm(p, p).sum((1, 2)) == 0


def acyclic(s: PPCCState) -> torch.Tensor:
    """bool[L]: with paths of length <= 1 a cycle could only be a
    2-cycle or a self-loop; check both directly."""
    two_cycle = (s.prec & s.prec.transpose(1, 2)).any(2).any(1)
    self_loop = torch.diagonal(s.prec, dim1=1, dim2=2).any(1)
    return ~(two_cycle | self_loop) & path_length_leq_one(s)


def classes_consistent(s: PPCCState) -> torch.Tensor:
    """bool[L]: arcs only run preceding -> preceded."""
    rows_ok = (~s.prec.any(2) | s.preceding).all(1)
    cols_ok = (~s.prec.any(1) | s.preceded).all(1)
    return rows_ok & cols_ok
