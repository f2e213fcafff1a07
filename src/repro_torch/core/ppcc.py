"""Prudent-Precedence protocol state and its transitions — the port of
``repro/core/ppcc.py``.

Every tensor carries a leading lane axis: set rows are ``int32[L, n, W]``
packed words (``core.bitset``), the precedence graph is ``bool[L, n, n]``
and per-slot flags are ``bool[L, n]``.  A single lane is ``L = 1``.  The
module holds:

* the scalar steps of the one-event engine, one slot ``i[l]`` and item
  ``x[l]`` per lane: ``try_read`` / ``try_write`` / ``try_op`` under the
  Prudent Precedence Rule, ``wc_acquire_locks``, ``can_commit``,
  ``commit`` and ``abort``;
* the cohort calls of the multipass chain (``cohort_select``,
  ``try_ops_batched``, ``cohort_step``, ``wc_acquire_many``) and the
  fused step of the fleet body (``cohort_step_fused``) with its carried
  ``Relations``;
* batch admission: ``admit_ops`` (one CUDA launch on the card),
  ``admit_ops_blocked`` and ``admit_order_degree``;
* the Theorem-1 checks.

Wait-to-commit lock ownership is derived, as in the reference: a slot
with ``haslocks[l, k]`` holds exclusive locks on exactly its
``write_set[l, k]`` items.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import bitset as B
from ..device import resolve
from ..kernels import ops as kops
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


def state_from_numpy(tree, device=None) -> PPCCState:
    """The port's ``PPCCState`` from a reference ``PPCCState`` whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, s)``): a lone state gains
    a lane axis of 1 and ``uint32`` words are viewed as ``int32``."""
    dev = resolve(device)
    single = np.ndim(tree.read_set) == 2

    def conv(name, x):
        a = np.array(x)
        if name in ("read_set", "write_set"):
            a = a.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a[None] if single
                                                     else a)).to(dev)
    return PPCCState(*(conv(f, getattr(tree, f))
                       for f in PPCCState._fields))


def state_to_numpy(s: PPCCState) -> PPCCState:
    """The port's ``PPCCState`` with numpy leaves in the reference's dtypes
    (``int32`` words viewed back as ``uint32``); the lane axis stays."""
    def conv(name, x):
        a = x.detach().cpu().numpy()
        return a.view(np.uint32) if name in ("read_set", "write_set") else a
    return PPCCState(*(conv(f, getattr(s, f)) for f in PPCCState._fields))


# --------------------------------------------------------------------------
# scalar steps: one slot i[l] and one item x[l] per lane (the one-event
# engine's transitions)
# --------------------------------------------------------------------------

def _lanes(s: PPCCState) -> torch.Tensor:
    return torch.arange(s.lanes, device=s.active.device)


def _me(s: PPCCState, i: torch.Tensor) -> torch.Tensor:
    """bool[L, n]: slot ``i[l]`` of each lane."""
    return torch.arange(s.n, device=i.device)[None, :] == i[:, None]


def _lock_verdict(s: PPCCState, i: torch.Tensor, x: torch.Tensor
                  ) -> torch.Tensor:
    """int32[L] (paper Fig. 3): PROCEED when ``x`` is unlocked or locked by
    ``i``, ABORT when ``i`` already precedes the lock's owner, BLOCK
    otherwise.  The owner is the holder whose write set covers ``x``."""
    owner = B.get_col(s.write_set, x) & s.haslocks               # [L, n]
    locked_by_other = (owner & ~_me(s, i)).any(1)
    i_precedes_owner = (owner & s.prec[_lanes(s), i.long(), :]).any(1)
    return torch.where(locked_by_other,
                       torch.where(i_precedes_owner, ABORT, BLOCK),
                       PROCEED).to(torch.int32)


def try_read(s: PPCCState, i: torch.Tensor, x: torch.Tensor):
    """Transaction ``i[l]`` reads item ``x[l]`` (paper Example 1): the
    reader precedes every uncommitted writer of ``x``; the rule admits the
    read iff the reader was never preceded and no such writer ever preceded
    anyone.  Returns (state, verdict int32[L])."""
    ln, il = _lanes(s), i.long()
    lock_v = _lock_verdict(s, i, x)
    prow = s.prec[ln, il, :]
    new = B.get_col(s.write_set, x) & s.active & ~_me(s, i) & ~prow
    any_new = new.any(1)
    rule_ok = ~s.preceded[ln, il] & ~(new & s.preceding).any(1)
    allowed = (lock_v == PROCEED) & (~any_new | rule_ok)
    verdict = torch.where(lock_v != PROCEED, lock_v,
                          torch.where(allowed, PROCEED, BLOCK))
    add = new & allowed[:, None]
    prec = s.prec.clone()
    prec[ln, il, :] = prow | add
    preceding = s.preceding.clone()
    preceding[ln, il] = s.preceding[ln, il] | (allowed & any_new)
    return s._replace(
        read_set=B.set_bit(s.read_set, i, x, allowed), prec=prec,
        preceding=preceding, preceded=s.preceded | add,
    ), verdict.to(torch.int32)


def try_write(s: PPCCState, i: torch.Tensor, x: torch.Tensor):
    """Transaction ``i[l]`` writes item ``x[l]`` in its workspace (paper
    Example 2): every current reader of ``x`` precedes the writer; admitted
    iff the writer never preceded anyone and no such reader was ever
    preceded.  Returns (state, verdict int32[L])."""
    ln, il = _lanes(s), i.long()
    lock_v = _lock_verdict(s, i, x)
    pcol = s.prec[ln, :, il]
    new = B.get_col(s.read_set, x) & s.active & ~_me(s, i) & ~pcol
    any_new = new.any(1)
    rule_ok = ~s.preceding[ln, il] & ~(new & s.preceded).any(1)
    allowed = (lock_v == PROCEED) & (~any_new | rule_ok)
    verdict = torch.where(lock_v != PROCEED, lock_v,
                          torch.where(allowed, PROCEED, BLOCK))
    add = new & allowed[:, None]
    prec = s.prec.clone()
    prec[ln, :, il] = pcol | add
    preceded = s.preceded.clone()
    preceded[ln, il] = s.preceded[ln, il] | (allowed & any_new)
    return s._replace(
        write_set=B.set_bit(s.write_set, i, x, allowed), prec=prec,
        preceded=preceded, preceding=s.preceding | add,
    ), verdict.to(torch.int32)


def _pick(m: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """where(m[l], a, b) with the per-lane mask broadcast over ``a``."""
    return torch.where(m.view(-1, *([1] * (a.dim() - 1))), a, b)


def try_op(s: PPCCState, i: torch.Tensor, x: torch.Tensor,
           is_write: torch.Tensor):
    """``try_write`` where ``is_write[l]``, else ``try_read``: both are
    computed and selected per lane, as the reference does."""
    sr, vr = try_read(s, i, x)
    sw, vw = try_write(s, i, x)
    return PPCCState(*(_pick(is_write, b, a) for a, b in zip(sr, sw))), \
        torch.where(is_write, vw, vr)


def wc_acquire_locks(s: PPCCState, i: torch.Tensor):
    """Wait-to-commit (paper Fig. 4): lock ``i[l]``'s whole write set, all
    or nothing.  Succeeds iff no other holder's write words meet ``i``'s
    (self-held locks pass).  Returns (state, acquired bool[L])."""
    ln, il = _lanes(s), i.long()
    hit = B.overlap_rows(s.write_set, s.write_set[ln, il][:, None, :])
    ok = ~(hit & s.haslocks & ~_me(s, i)).any(1)
    haslocks = s.haslocks.clone()
    haslocks[ln, il] = s.haslocks[ln, il] | ok
    return s._replace(haslocks=haslocks), ok


def can_commit(s: PPCCState, i: torch.Tensor) -> torch.Tensor:
    """bool[L] (paper Fig. 4): no active transaction precedes ``i[l]``."""
    return ~(s.prec[_lanes(s), :, i.long()] & s.active).any(1)


def _leave(s: PPCCState, i: torch.Tensor) -> PPCCState:
    """Transaction ``i[l]`` leaves: its arcs, sets and locks drop."""
    return _leave_many(s, _me(s, i))


def commit(s: PPCCState, i: torch.Tensor) -> PPCCState:
    return _leave(s, i)


def abort(s: PPCCState, i: torch.Tensor) -> PPCCState:
    return _leave(s, i)


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


def op_parties(s: PPCCState, item: torch.Tensor, is_write: torch.Tensor
               ) -> torch.Tensor:
    """party[l, i, k]: slot i's pending op touches slot k's state."""
    writers_at, readers_at = _op_tables(s, item)
    return _parties(s, is_write, writers_at, readers_at)


def _select(s: PPCCState, item, is_write, ready, writers_at, readers_at):
    """Selected: ready slots no lower-indexed ready slot depends on."""
    idx = torch.arange(s.n, device=item.device)
    dep = _dep_matrix(s, item, is_write, writers_at, readers_at)
    lower = idx[None, :] < idx[:, None]
    return ready & ~(dep & ready[:, None, :] & lower).any(2)


def cohort_select(s: PPCCState, item: torch.Tensor, is_write: torch.Tensor,
                  ready: torch.Tensor) -> torch.Tensor:
    """A pairwise-independent subset of ``ready`` in one step: slot i is
    selected iff no lower-indexed ready slot's op depends on it.  The
    lowest ready slot is always selected."""
    writers_at, readers_at = _op_tables(s, item)
    return _select(s, item, is_write, ready, writers_at, readers_at)


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


def try_ops_batched(s: PPCCState, item: torch.Tensor,
                    is_write: torch.Tensor, mask: torch.Tensor):
    """One op per masked slot, resolved in one step against the pre-state
    (the masked ops must be pairwise independent: ``cohort_select``).
    Unmasked slots report BLOCK.  Returns (state, verdict int32[L, n])."""
    writers_at, readers_at = _op_tables(s, item)
    s2, verdict, _ = _try_ops(s, item, is_write, mask, writers_at,
                              readers_at)
    return s2, verdict


def cohort_step(s: PPCCState, item: torch.Tensor, is_write: torch.Tensor,
                ready: torch.Tensor):
    """``cohort_select`` + ``try_ops_batched`` on one set of gathers: the
    multipass chain's read-phase step.  Returns (state, verdict, selected,
    block-reason codes)."""
    writers_at, readers_at = _op_tables(s, item)
    sel = _select(s, item, is_write, ready, writers_at, readers_at)
    s2, verdict, reason = _try_ops(s, item, is_write, sel, writers_at,
                                   readers_at)
    return s2, verdict, sel, reason


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


def wc_acquire_many(s: PPCCState, mask: torch.Tensor, exact: bool = True):
    """Batched all-or-nothing wait-to-commit lock acquisition of the
    masked slots.  Slot i is feasible iff no other current holder's write
    words meet its own.  Returns (state, won bool[L, n]); losers keep the
    state they had.

    ``exact=True`` is the event engine's sequential greedy: in index
    order, i wins iff it is feasible and its write words meet no earlier
    winner's.  That is ``scheduler.twopl_tick``'s walk with conflict row
    ``raw | raw^T | ww`` off the diagonal, here with ``raw`` all False and
    ``ww`` the write-write overlap (symmetric, diagonal cleared): the same
    function, so it runs as one ``kernels.ops.twopl_admit`` launch per
    lane on the card and its plain loop on the CPU.  ``exact=False`` is
    the engine's one-step relaxation: i wins iff feasible and no lower
    feasible slot overlaps it (a subset of the greedy winners)."""
    n = s.n
    idx = torch.arange(n, device=mask.device)
    overlap = B.any_overlap(s.write_set, s.write_set) & ~_eye(n, mask.device)
    feasible = mask & ~(overlap & s.haslocks[:, None, :]).any(2)
    if exact:
        raw = torch.zeros((n, n), dtype=torch.bool, device=mask.device)
        won = torch.stack([kops.twopl_admit(raw, overlap[l].contiguous(),
                                            feasible[l].contiguous())
                           for l in range(s.lanes)]) if s.lanes else \
            torch.zeros_like(mask)
    else:
        lower = idx[None, :] < idx[:, None]
        won = feasible & ~(overlap & feasible[:, None, :] & lower).any(2)
    return s._replace(haslocks=s.haslocks | won), won


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
# batch admission
# --------------------------------------------------------------------------

class BatchVerdict(NamedTuple):
    admitted: torch.Tensor   # bool[L, m] ops admitted this round
    blocked: torch.Tensor    # bool[L, m]
    aborted: torch.Tensor    # bool[L, m]
    state: PPCCState


def _op_list(s: PPCCState, txn, item, is_write, valid, name: str):
    """The op list as contiguous ``[L, m]`` int32 / bool tensors on the
    state's device.  Raises ``ValueError`` where a valid op's ``txn`` is
    outside ``[0, n)`` or its ``item`` outside ``[0, 32 W)`` (one host
    read); the reference clamps or drops such an op instead."""
    dev = s.active.device
    txn = torch.as_tensor(txn, device=dev).to(torch.int32).contiguous()
    item = torch.as_tensor(item, device=dev).to(torch.int32).contiguous()
    is_write = torch.as_tensor(is_write, device=dev).bool().contiguous()
    valid = torch.as_tensor(valid, device=dev).bool().contiguous()
    shape = (s.lanes, txn.shape[-1] if txn.dim() else -1)
    for arg, t in (("txn", txn), ("item", item), ("is_write", is_write),
                   ("valid", valid)):
        if t.dim() != 2 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be [L, m] with L = "
                             f"{s.lanes} and one m, got {tuple(t.shape)}")
    bad = valid & ((txn < 0) | (txn >= s.n) | (item < 0)
                   | (item >= s.words * B.WORD))
    if bool(bad.any()):
        raise ValueError(f"{name}: a valid op's txn is outside [0, {s.n}) "
                         f"or its item outside [0, {s.words * B.WORD})")
    return txn, item, is_write, valid


def admit_ops(s: PPCCState, txn, item, is_write, valid) -> BatchVerdict:
    """Admit each lane's op list ``[L, m]`` in list order under the Prudent
    Precedence Rule: exactly one ``try_op`` per valid op, in sequence (the
    rule is order-dependent); invalid ops change nothing and report no
    verdict.  One ``admit_ops`` launch on the card (``csrc/admit_ops.cu``),
    the plain loop ``kernels.ref.admit_ops_ref`` on the CPU.  A valid op
    out of range raises ``ValueError``."""
    ops = _op_list(s, txn, item, is_write, valid, "admit_ops")
    out = kops.admit_ops(*(x.contiguous() for x in s), *ops)
    return BatchVerdict(out[0], out[1], out[2], PPCCState(*out[3:]))


def default_admit_block(n: int) -> int:
    """The reference's block size for ``admit_ops_blocked``: the largest
    power of two at most sqrt(n), and at least 8."""
    b = 1
    while (2 * b) ** 2 <= n:        # largest power of two <= sqrt(n)
        b *= 2
    return max(8, b)


def admit_order_degree(s: PPCCState, txn, item, is_write, valid
                       ) -> torch.Tensor:
    """Degree-ordered admission permutation, ``int32[L, m]``: op positions
    in admission order.  Primary key: the op's occurrence rank within its
    own transaction; secondary: the issuing transaction's conflict degree
    over the batch's would-be read and write sets (RAW out + WAR in + WW,
    self-conflicts stripped); ties by original index.

    The reference's ``lexsort`` is three stable sorts here (index, then
    degree, then rank), and its dropped scatters of invalid ops go to an
    extra row ``n`` that is sliced off.  A valid op out of range raises
    ``ValueError``."""
    txn, item, is_write, valid = _op_list(s, txn, item, is_write, valid,
                                          "admit_order_degree")
    lanes, m = txn.shape
    n, dev = s.n, txn.device
    d_pad = s.words * B.WORD
    ln = torch.arange(lanes, device=dev)[:, None].expand(lanes, m)

    def dense(mask):
        out = torch.zeros((lanes, n + 1, d_pad), dtype=torch.bool,
                          device=dev)
        out[ln, torch.where(mask, txn, n).long(),
            torch.where(mask, item, 0).long()] = True
        return out[:, :n].float()

    read_b, write_b = dense(valid & ~is_write), dense(valid & is_write)
    # exact 0/1 products: counts stay far below 2**24
    raw = torch.bmm(read_b, write_b.transpose(1, 2)) > 0
    ww = torch.bmm(write_b, write_b.transpose(1, 2)) > 0
    i32 = torch.int32
    self_r = torch.diagonal(raw, dim1=1, dim2=2).to(i32)
    deg = (raw.sum(2, dtype=i32) - self_r + raw.sum(1, dtype=i32) - self_r
           + ww.sum(2, dtype=i32)
           - torch.diagonal(ww, dim1=1, dim2=2).to(i32))
    # rank: earlier ops of the same txn (a stable sort groups them)
    pos = torch.arange(m, device=dev).expand(lanes, m)
    by_txn = torch.sort(txn, dim=1, stable=True).indices
    st = txn.gather(1, by_txn)
    first = torch.ones_like(st, dtype=torch.bool)
    first[:, 1:] = st[:, 1:] != st[:, :-1]
    start = torch.cummax(torch.where(first, pos, 0), dim=1).values
    rank = torch.empty_like(pos).scatter_(1, by_txn, pos - start)
    # deg[txn] as the reference gathers it: a negative index wraps, then
    # the index is clamped into [0, n)
    t = torch.where(txn < 0, txn + n, txn).clamp(0, max(n - 1, 0)).long()
    deg_t = deg.gather(1, t) if n else torch.zeros_like(txn)
    perm = pos.clone()
    for key in (deg_t, rank):
        perm = perm.gather(1, torch.sort(key.gather(1, perm), dim=1,
                                         stable=True).indices)
    return perm.to(i32)


def admit_ops_blocked(s: PPCCState, txn, item, is_write, valid,
                      block: int = None, order: str = "index"
                      ) -> BatchVerdict:
    """``admit_ops`` under the reference's blocked API.

    ``order="index"`` admits the list in list order; ``order="degree"``
    admits it in the ``admit_order_degree`` permutation, with verdicts
    reported in the original op positions.  The reference cuts the list
    into blocks of ``block`` ops and resolves a block of independent ops
    in one vectorised step, an XLA device whose result is bit-identical to
    ``admit_ops`` by contract; here the list goes to ``admit_ops`` whole,
    so ``block`` changes no result.  It is still validated (a positive
    int; ``None`` picks the reference's default)."""
    if order not in ("index", "degree"):
        raise ValueError(f"unknown admission order: {order!r}")
    if block is None:
        block = default_admit_block(s.n) * (2 if order == "degree" else 1)
    if isinstance(block, bool) or not isinstance(block, int) or block <= 0:
        raise ValueError(f"block must be a positive int, got {block!r}")
    txn, item, is_write, valid = _op_list(s, txn, item, is_write, valid,
                                          "admit_ops_blocked")
    if order == "index":
        return admit_ops(s, txn, item, is_write, valid)
    perm = admit_order_degree(s, txn, item, is_write, valid).long()
    res = admit_ops(s, *(a.gather(1, perm)
                         for a in (txn, item, is_write, valid)))
    pos = torch.arange(perm.shape[1], device=perm.device).expand_as(perm)
    inv = torch.empty_like(perm).scatter_(1, perm, pos)
    return BatchVerdict(res.admitted.gather(1, inv),
                        res.blocked.gather(1, inv),
                        res.aborted.gather(1, inv), res.state)


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
