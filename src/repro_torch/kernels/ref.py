"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes exactly what its CUDA kernel computes, with the
same lane axis and dtypes.  The CPU path of ``kernels.ops`` runs them,
the CPU tests hold them to the JAX reference, and ``chip_smoke.py``
holds each kernel to them on the card: bit-equal for the integer and
logic kernels, within a stated tolerance for the float kernels of the
language model (``flash_attention_ref`` and its backward
``flash_attention_bwd_ref``, ``wkv_chunked_ref`` and its backward
``wkv_chunked_bwd_ref``), whose sums the kernels take in another
order.  ``wkv_ref`` is the sequential WKV recurrence, the
oracle of both.
"""
from __future__ import annotations

from typing import Optional

import torch

INF = 1.0000000150474662e30        # float32(1e30), the engine's idle time


def _item_table(bits: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """bool[L, m, n]: ``[l, i, k]`` = bit ``items[l, i]`` of row k."""
    lanes, n = bits.shape[0], bits.shape[1]
    cols = torch.gather(bits.transpose(1, 2), 1,
                        (items >> 5)[:, :, None].expand(lanes, -1, n))
    return ((cols >> (items & 31)[:, :, None]) & 1).bool()


def megastep_ref(read_bits: torch.Tensor, write_bits: torch.Tensor,
                 dirty_bits: torch.Tensor, item: torch.Tensor,
                 is_write: torch.Tensor, active: torch.Tensor,
                 ready: torch.Tensor, haslocks: torch.Tensor):
    """The cohort-step relations of every lane: ``(dep, ww, writers_at,
    readers_at, deg, lockhit, dirty_hit)``.

    Words are ``int32[L, n, W]``, ``item`` is ``int32[L, n]`` and the
    flags are ``bool[L, n]``.  ``dep``/``ww``/``writers_at``/
    ``readers_at`` are ``bool[L, n, n]``, ``deg`` is ``int32[L, n]`` and
    ``lockhit``/``dirty_hit`` are ``bool[L, n]`` — the counterpart of
    ``repro.kernels.ref.megastep_ref`` with a lane axis."""
    n = read_bits.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=read_bits.device)
    writers_at = _item_table(write_bits, item)
    readers_at = _item_table(read_bits, item)
    others = torch.where(is_write[:, :, None], readers_at, writers_at)
    party = (others & active[:, None, :] & ~eye) | eye
    dep = (party[:, :, None, :] & party[:, None, :, :]).any(-1)
    same_item = item[:, :, None] == item[:, None, :]
    either_w = is_write[:, :, None] | is_write[:, None, :]
    dep = (dep | (same_item & either_w)) & ~eye
    deg = (dep & ready[:, None, :]).sum(2, dtype=torch.int32)
    ww = ((write_bits[:, :, None, :] & write_bits[:, None, :, :]) != 0
          ).any(-1) & ~eye
    lockhit = (ww & haslocks[:, None, :]).any(2)
    dirty_hit = ((read_bits & dirty_bits) != 0).any(-1)
    return dep, ww, writers_at, readers_at, deg, lockhit, dirty_hit


def rowslab_ref(read_bits: torch.Tensor, write_bits: torch.Tensor,
                writers_at: torch.Tensor, readers_at: torch.Tensor,
                item: torch.Tensor, is_write: torch.Tensor,
                active: torch.Tensor, slab: torch.Tensor,
                valid: torch.Tensor):
    """The dirty-row slab of every lane: ``(dep_rows, ww_rows, wat_rows,
    rat_rows)``, each ``bool[L, K, n]``, the rows of a full recompute of
    the relations for the K slot ids ``slab[l]`` (``int32[L, K]``;
    entries where ``valid`` is False may be any id and give zero rows).

    ``writers_at``/``readers_at`` are the carried ``bool[L, n, n]`` op
    tables; the fresh rows of the slab slots are substituted in before
    the party rows are formed, so the dep rows are a full recompute's
    whenever every other row of the carried tables is current.  Words
    are ``int32[L, n, W]``, ``item`` ``int32[L, n]``, flags ``bool[L,
    n]`` — ``repro.kernels.ref.rowslab_ref`` with a lane axis."""
    lanes, n = read_bits.shape[0], read_bits.shape[1]
    dev = read_bits.device
    sl = slab.clamp(0, n - 1).to(torch.int64)
    s_item = item.gather(1, sl)                              # [L, K]
    wat_rows = _item_table(write_bits, s_item)               # [L, K, n]
    rat_rows = _item_table(read_bits, s_item)
    # substitute the fresh rows; invalid entries write the dropped row n
    tgt = torch.where(valid, sl, n)[:, :, None].expand(-1, -1, n)

    def substitute(table, rows):
        padded = torch.nn.functional.pad(table, (0, 0, 0, 1))
        return padded.scatter(1, tgt, rows)[:, :n]

    wat2 = substitute(writers_at, wat_rows)
    rat2 = substitute(readers_at, rat_rows)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    others = torch.where(is_write[:, :, None], rat2, wat2)
    party = (others & active[:, None, :] & ~eye) | eye       # [L, n, n]
    party_s = party.gather(1, sl[:, :, None].expand(-1, -1, n))
    dep_rows = (party_s[:, :, None, :] & party[:, None, :, :]).any(-1)
    same_item = s_item[:, :, None] == item[:, None, :]
    either_w = is_write.gather(1, sl)[:, :, None] | is_write[:, None, :]
    eye_s = sl[:, :, None] == torch.arange(n, device=dev)[None, None, :]
    dep_rows = (dep_rows | (same_item & either_w)) & ~eye_s
    ws = write_bits.gather(1, sl[:, :, None].expand(-1, -1,
                                                    write_bits.shape[2]))
    ww_rows = ((ws[:, :, None, :] & write_bits[:, None, :, :]) != 0
               ).any(-1) & ~eye_s
    v = valid[:, :, None]
    return dep_rows & v, ww_rows & v, wat_rows & v, rat_rows & v



def padded_tables(tables) -> torch.Tensor:
    """Four ``bool[L, n, n]`` tables (dep, ww, writers_at, readers_at) in
    one ``bool[4, L, n+1, n+1]`` buffer, with a padded row and column n
    that take the writes of invalid slab entries (``scatter_padded_``)."""
    lanes, n = tables[0].shape[0], tables[0].shape[1]
    buf = torch.zeros((4, lanes, n + 1, n + 1), dtype=torch.bool,
                      device=tables[0].device)
    for dst, src in zip(buf, tables):
        dst[:, :n, :n] = src
    return buf


def unpadded_tables(buf: torch.Tensor) -> tuple:
    """The four ``bool[L, n, n]`` views of a ``padded_tables`` buffer."""
    n = buf.shape[2] - 1
    return tuple(buf[:, :, :n, :n].unbind(0))


def scatter_padded_(buf: torch.Tensor, rows: torch.Tensor,
                    slab: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Write a row slab's ``bool[4, L, K, n]`` row blocks (dep, ww,
    writers_at, readers_at) into a ``padded_tables`` buffer, in place:
    rows for all four, then the mirrored columns of the symmetric
    dep/ww, so a column write wins at ``[a, b]`` for two slab ids a and
    b.  Invalid entries write row and column n, so no two writes race on
    a live entry.  Returns ``buf``."""
    _, lanes, k, n = rows.shape
    tgt = torch.where(valid, slab, n).to(torch.int64)
    buf.scatter_(2, tgt[None, :, :, None].expand(4, lanes, k, n), rows)
    buf[:2].scatter_(3, tgt[None, :, None, :].expand(2, lanes, n, k),
                     rows[:2].transpose(2, 3))
    return buf


def rowslab_drain_ref(read_bits: torch.Tensor, write_bits: torch.Tensor,
                      dep: torch.Tensor, ww: torch.Tensor,
                      writers_at: torch.Tensor, readers_at: torch.Tensor,
                      item: torch.Tensor, is_write: torch.Tensor,
                      active: torch.Tensor, dirty: torch.Tensor, *,
                      k: int = 0):
    """The next iteration's relation tables of every lane after
    recomputing the rows of its dirty slots (``dirty``, ``bool[L, n]``):
    ``(dep', ww', writers_at', readers_at')``, each ``bool[L, n, n]``.

    The reference's fleet drain (``repro.core.jaxsim._delta_update``)
    with a lane axis: each lane's dirty ids, ascending, in slabs of
    ``k`` (``k <= 0``: one slab of n); each slab's rows from
    ``rowslab_ref`` against the tables the earlier slabs wrote, then
    scattered back, rows and mirrored dep/ww columns.  Later slabs'
    columns repair the entries between their slots and earlier ones, so
    the result does not depend on ``k``.  The carried tables are not
    written.  Words are ``int32[L, n, W]``, ``item`` ``int32[L, n]``,
    flags ``bool[L, n]``."""
    lanes, n = dirty.shape
    k = n if k <= 0 else k
    chunks = -(-n // k)
    ids = torch.arange(n, dtype=torch.int32, device=dirty.device)
    ids = torch.where(dirty, ids, n).sort(1).values
    ids = torch.nn.functional.pad(ids, (0, chunks * k - n), value=n)
    buf = padded_tables((dep, ww, writers_at, readers_at))
    for slab in ids.view(lanes, chunks, k).unbind(1):
        valid = slab < n
        tables = unpadded_tables(buf)
        rows = rowslab_ref(read_bits, write_bits, tables[2], tables[3], item,
                           is_write, active, slab, valid)
        scatter_padded_(buf, torch.stack(rows), slab, valid)
    return tuple(t.contiguous() for t in unpadded_tables(buf))

def reserve_cohort_ref(cpu_free: torch.Tensor, disk_free: torch.Tensor,
                       t_req: torch.Tensor, cpu_dur: torch.Tensor,
                       io_dur: torch.Tensor, cpu_m: torch.Tensor,
                       disk_m: torch.Tensor):
    """FCFS multi-reservation for every lane's cohort: walk the slots in
    index order; a masked slot takes the first ``argmin`` server of its
    pool, starting at ``max(t_req, free_at)``.  Returns ``(cpu_free',
    disk_free', cpu_done[L, n], disk_done[L, n])`` with ``INF`` where a
    slot made no request — ``repro.core.jaxsim._reserve_cohort`` with a
    lane axis."""
    cpu = cpu_free.clone()
    disk = disk_free.clone()
    lanes = torch.arange(cpu.shape[0], device=cpu.device)
    inf = torch.full((), INF, dtype=torch.float32, device=cpu.device)
    cpu_done, disk_done = [], []
    for i in range(t_req.shape[1]):
        t = t_req[:, i]
        ci = cpu.argmin(1)
        cdone = torch.maximum(t, cpu[lanes, ci]) + cpu_dur[:, i]
        cm = cpu_m[:, i]
        cpu[lanes, ci] = torch.where(cm, cdone, cpu[lanes, ci])
        di = disk.argmin(1)
        ddone = torch.maximum(t, disk[lanes, di]) + io_dur[:, i]
        dm = disk_m[:, i]
        disk[lanes, di] = torch.where(dm, ddone, disk[lanes, di])
        cpu_done.append(torch.where(cm, cdone, inf))
        disk_done.append(torch.where(dm, ddone, inf))
    return cpu, disk, torch.stack(cpu_done, 1), torch.stack(disk_done, 1)


def occ_validate_ref(commit_pre: torch.Tensor, read_bits: torch.Tensor,
                     dirty_bits: torch.Tensor, write_bits: torch.Tensor
                     ) -> torch.Tensor:
    """OCC same-iteration validation: walk the slots in index order; a
    would-be committer fails when its read row meets its dirty row or
    the write rows of the lower committers that survived.  Returns
    ``bool[L, n]`` failures — the ``occ_validate_multi`` scan of
    ``repro.core.jaxsim._cohort_body`` with a lane axis."""
    acc = torch.zeros_like(read_bits[:, 0])
    fails = []
    for i in range(read_bits.shape[1]):
        c = commit_pre[:, i]
        fail = c & ((read_bits[:, i] & (dirty_bits[:, i] | acc)) != 0
                    ).any(-1)
        acc = acc | torch.where((c & ~fail)[:, None], write_bits[:, i], 0)
        fails.append(fail)
    return torch.stack(fails, 1)


# ---- the batch scheduler's kernels (csrc/conflict.cu, csrc/admit.cu) ----

PLAIN_BLOCK_BYTES = 1 << 30    # largest [rows, N, W] word block at once


def _overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[N, M]: row i of ``a`` meets row j of ``b`` (int32 words
    ``[N, W]``, ``[M, W]``).  Rows of ``a`` go in blocks whose ``[rows, M,
    W]`` AND stays within ``PLAIN_BLOCK_BYTES``: at N = M = 4,096,
    W = 1,024 the whole broadcast would be 68 GB."""
    n, w = a.shape
    m = b.shape[0]
    rows = max(1, PLAIN_BLOCK_BYTES // max(1, m * w * 4))
    out = torch.empty((n, m), dtype=torch.bool, device=a.device)
    for i0 in range(0, n, rows):
        out[i0:i0 + rows] = ((a[i0:i0 + rows, None, :] & b[None]) != 0
                             ).any(-1)
    return out


def conflict_matrix_ref(read_bits: torch.Tensor, write_bits: torch.Tensor
                        ) -> torch.Tensor:
    """``raw[i, j]``: read row i meets write row j — words ``int32[N, W]``
    -> ``bool[N, N]``, ``repro.kernels.ref.conflict_matrix_ref``."""
    return _overlap(read_bits, write_bits)


def conflict_fused_ref(read_bits: torch.Tensor, write_bits: torch.Tensor):
    """``(raw, ww, raw_deg, ww_deg)``: both relations and their int32 row
    degrees, the diagonal counted — ``ref.conflict_fused_ref``."""
    raw = _overlap(read_bits, write_bits)
    ww = _overlap(write_bits, write_bits)
    return (raw, ww, raw.sum(1, dtype=torch.int32),
            ww.sum(1, dtype=torch.int32))


def conflict_fused_full_ref(read_bits: torch.Tensor,
                            write_bits: torch.Tensor):
    """``(raw, ww, raw_deg, war_deg, ww_deg, diag_raw, diag_ww)``:
    ``conflict_fused_ref`` plus raw's column degrees and both diagonals —
    ``ref.conflict_fused_full_ref``."""
    raw, ww, raw_deg, ww_deg = conflict_fused_ref(read_bits, write_bits)
    return (raw, ww, raw_deg, raw.sum(0, dtype=torch.int32), ww_deg,
            raw.diagonal().clone(), ww.diagonal().clone())


def ppcc_admit_ref(raw: torch.Tensor, valid: torch.Tensor,
                   seq: torch.Tensor):
    """PPCC admission in the order ``seq``: one step of the ``lax.scan``
    of ``repro.sched.scheduler.ppcc_tick`` per transaction.  ``raw`` is
    ``bool[n, n]`` with its diagonal cleared, ``valid`` ``bool[n]``,
    ``seq`` ``int32[n]``.  Returns ``(admitted, preceding, preceded,
    prec[n, n])``."""
    n = raw.shape[0]
    dev = raw.device
    admitted = torch.zeros(n, dtype=torch.bool, device=dev)
    preceding = torch.zeros_like(admitted)
    preceded = torch.zeros_like(admitted)
    prec = torch.zeros((n, n), dtype=torch.bool, device=dev)
    for i in seq.tolist():
        r_i = raw[i] & admitted                      # i -> j arcs (RAW)
        w_i = raw[:, i] & admitted                   # k -> i arcs (WAR)
        any_r, any_w = r_i.any(), w_i.any()
        ok = (valid[i] & ~(any_r & any_w) & ~(r_i & preceding).any()
              & ~(w_i & preceded).any())
        admitted[i] = ok                             # in place: r_i and
        preceding[i] = ok & any_r                    # w_i are copies
        preceding |= w_i & ok
        preceded[i] = ok & any_w
        preceded |= r_i & ok
        prec[i, :] = torch.where(ok, r_i, prec[i, :])
        prec[:, i] = torch.where(ok, w_i, prec[:, i])
    return admitted, preceding, preceded, prec


def twopl_admit_ref(raw: torch.Tensor, ww: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """2PL admission in index order: ``i`` is admitted unless
    ``(raw | raw^T | ww)`` off the diagonal meets an admitted ``j`` — the
    scan of ``scheduler.twopl_tick``.  Returns ``admitted bool[n]``."""
    n = raw.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=raw.device)
    conflict = (raw | raw.T | ww) & ~eye
    admitted = torch.zeros(n, dtype=torch.bool, device=raw.device)
    for i in range(n):
        ok = valid[i] & ~(conflict[i] & admitted).any()
        admitted[i] = ok
    return admitted


def occ_admit_ref(raw: torch.Tensor, ww: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """OCC backward validation in index order: ``i`` survives unless
    ``raw | ww`` meets an earlier survivor — the scan of
    ``scheduler.occ_tick``.  Returns ``survivors bool[n]``."""
    n = raw.shape[0]
    bad = raw | ww
    idx = torch.arange(n, device=raw.device)
    survivors = torch.zeros(n, dtype=torch.bool, device=raw.device)
    for i in range(n):
        earlier = idx < i
        ok = valid[i] & ~(bad[i] & survivors & earlier).any()
        survivors[i] = ok
    return survivors


# admit_ops verdicts (core.ppcc's PROCEED, BLOCK, ABORT)
_PROCEED, _BLOCK, _ABORT = 0, 1, 2


def admit_ops_ref(read_set: torch.Tensor, write_set: torch.Tensor,
                  prec: torch.Tensor, preceding: torch.Tensor,
                  preceded: torch.Tensor, active: torch.Tensor,
                  haslocks: torch.Tensor, txn: torch.Tensor,
                  item: torch.Tensor, is_write: torch.Tensor,
                  valid: torch.Tensor):
    """PPCC admission of an op list in list order, every lane at once: the
    ``lax.scan`` of ``repro.core.ppcc.admit_ops``, one ``try_op`` step per
    op, applied in place to a copy of the state.

    The state is ``core.ppcc.PPCCState``'s seven leaves (``int32[L, n, W]``
    sets, ``bool[L, n, n]`` prec, ``bool[L, n]`` flags); the ops are
    ``[L, m]`` (``txn``, ``item`` int32, ``is_write``, ``valid`` bool).
    A valid op's ``txn`` and ``item`` must lie in ``[0, n)`` and
    ``[0, 32 W)`` (``ppcc.admit_ops`` checks); an invalid op changes
    nothing.  Returns ``(admitted, blocked, aborted)`` ``bool[L, m]``
    followed by the seven leaves of the new state."""
    sets = torch.stack((read_set, write_set), 1)          # [L, 2, n, W]
    classes = torch.stack((preceding, preceded), 1)       # [L, 2, n]
    prec = prec.clone()
    lanes, _, n, _ = sets.shape
    dev = sets.device
    ar = torch.arange(lanes, device=dev)
    me_all = torch.arange(n, device=dev)
    # per op: slot, word, bit, kind (an invalid op reads slot 0, item 0)
    t_all = torch.where(valid, txn, 0).long()
    x_all = torch.where(valid, item, 0).long()
    steps = zip(t_all.unbind(1), (x_all >> 5).unbind(1),
                (x_all & 31).unbind(1), is_write.long().unbind(1),
                valid.unbind(1))
    verdicts = []
    for t, wd, b, w, v in steps:
        wb = w.bool()[:, None]
        bits = ((sets[ar, :, :, wd] >> b[:, None, None]) & 1).bool()
        rcol, wcol = bits[:, 0], bits[:, 1]                 # [L, n]
        me = me_all[None, :] == t[:, None]
        prow, pcol = prec[ar, t, :], prec[ar, :, t]
        # the lock verdict: an owner of x holds locks and writes it
        owner = wcol & haslocks
        lock_v = torch.where((owner & ~me).any(1), torch.where(
            (owner & prow).any(1), _ABORT, _BLOCK), _PROCEED)
        # the Prudent Precedence Rule on the arcs the op would add: a read
        # t -> the active writers it does not yet precede (t must never
        # have been preceded, none of them may precede), a write the
        # active readers not yet preceding t -> t (the mirror image)
        new = torch.where(wb, rcol & ~pcol, wcol & ~prow) & active & ~me
        any_new = new.any(1)
        mine = classes[ar, w]           # read: preceding, write: preceded
        theirs = classes[ar, 1 - w]     # read: preceded, write: preceding
        allowed = (lock_v == _PROCEED) & v & (~any_new | ~(
            theirs[ar, t] | (new & mine).any(1)))
        verdicts.append(torch.where(v, torch.where(
            lock_v != _PROCEED, lock_v,
            torch.where(allowed, _PROCEED, _BLOCK)), _BLOCK))
        # apply: the set bit, the arcs, the class bits
        add = new & allowed[:, None]
        word = (sets[ar, w, t, wd].long() & 0xFFFFFFFF) | (
            allowed.long() << b)
        sets[ar, w, t, wd] = (((word + 2 ** 31) & 0xFFFFFFFF)
                              - 2 ** 31).to(torch.int32)
        prec[ar, t, :] = prow | (add & ~wb)
        prec[ar, :, t] = pcol | (add & wb)
        classes[ar, 1 - w] = theirs | add
        classes[ar, w, t] = mine[ar, t] | (allowed & any_new)
    verdict = torch.stack(verdicts, 1) if verdicts else \
        torch.full((lanes, 0), _BLOCK, device=dev)
    return ((verdict == _PROCEED) & valid, (verdict == _BLOCK) & valid,
            (verdict == _ABORT) & valid, sets[:, 0].contiguous(),
            sets[:, 1].contiguous(), prec, classes[:, 0].contiguous(),
            classes[:, 1].contiguous(), active.clone(), haslocks.clone())


def _flash_mask(s: int, t: int, causal: bool, window: int, device
                ) -> torch.Tensor:
    """``bool [s, t]``: key j kept for query i when ``i >= j`` (causal,
    indices from 0) and ``i - j < window`` (window > 0)."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        sm_scale: Optional[float] = None,
                        return_lse: bool = False):
    """Softmax attention: q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Sk, D]``
    (any strides), query head h reading KV head h // (Hq / Hkv).  Scores
    and weights in float32; key j is masked for query i unless ``i >= j``
    (causal, indices from 0, aligned top-left when Sq != Sk) and
    ``i - j < window`` (window > 0); a row with every key masked is 0.
    Returns a contiguous ``[B, Hq, Sq, D]`` tensor in q's dtype, and with
    ``return_lse`` the float32 ``[B, Hq, Sq]`` logsumexp of each row's
    scaled scores (-inf for a wholly masked row)."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    s_ = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    mask = _flash_mask(s, t, causal, window, q.device)
    s_ = s_.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s_, dim=-1).nan_to_num(0.0)      # fully-masked rows
    out = torch.einsum("bhst,bhtd->bhsd", w, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s_, dim=-1)
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            sm_scale: Optional[float] = None):
    """The gradients ``(dq, dk, dv)`` of ``flash_attention_ref``'s output
    ``out`` with row logsumexp ``lse`` against ``dout``, by the explicit
    formulas (no autograd), float32 inside: ``P = exp(S * scale - lse)``
    on the kept pairs (0 elsewhere, so a wholly masked row has zero
    gradient), ``dV = P^T dO``, ``dS = P (dO V^T - rowsum(dO O))``,
    ``dQ = scale dS K``, ``dK = scale dS^T Q``; dk and dv of a KV head sum
    over its Hq / Hkv query heads.  Returns contiguous tensors in the
    dtypes of q, k, v."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else d ** -0.5
    qf, of, gf = q.float(), out.float(), dout.float()
    kf, vf = k.float(), v.float()
    if g > 1:
        kf = kf.repeat_interleave(g, dim=1)
        vf = vf.repeat_interleave(g, dim=1)
    s_ = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    mask = _flash_mask(s, t, causal, window, q.device)
    p = torch.where(mask, torch.exp(s_ - lse.float()[..., None]), 0.0)
    delta = (gf * of).sum(-1, keepdim=True)
    dv = torch.einsum("bhst,bhsd->bhtd", p, gf)
    ds = p * (torch.einsum("bhsd,bhtd->bhst", gf, vf) - delta)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    if g > 1:
        dk = dk.view(b, hkv, g, t, d).sum(2)
        dv = dv.view(b, hkv, g, t, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def wkv_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_w: torch.Tensor, u: torch.Tensor, *,
                    chunk: int = 64, state0: Optional[torch.Tensor] = None,
                    return_states: bool = False):
    """Chunked RWKV6 WKV, the math of ``repro/kernels/wkv.py`` and of the
    model's ``rwkv.wkv_chunked``: r/k/v/log_w ``[B, H, S, D]`` (any
    strides; log_w float32), u ``[H, D]`` float32, ``S`` a multiple of
    ``chunk``.  Per chunk: r against the carried state, the decayed
    r k^T in the strict lower triangle centred by ``cum_last / 2``, the
    ``u`` bonus on the diagonal, then the state update.  Returns (out
    ``[B, H, S, D]`` float32, final state ``[B, H, D, D]`` float32), and
    with ``return_states`` also the state entering each chunk, float32
    ``[B, H, S / chunk, D, D]`` (what ``wkv_chunked_bwd_ref`` takes)."""
    b, h, s, d = r.shape
    if s % chunk:
        raise ValueError(f"wkv_chunked_ref: S={s} is not a multiple of "
                         f"chunk={chunk}")
    state = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
    uu = u.float()[None, :, None, :]                          # [1,H,1,D]
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=r.device).tril(-1)
    outs, states = [], []
    for c0 in range(0, s, chunk):
        states.append(state)
        rq, kq, vq, wq = (x[:, :, c0:c0 + chunk].float()
                          for x in (r, k, v, log_w))
        cum = wq.cumsum(2)                    # inclusive cumulative decay
        cum_excl = cum - wq
        y_state = (rq * torch.exp(cum_excl)) @ state
        last = cum[:, :, -1:]                 # [B,H,1,D]
        c = last * 0.5
        a = (rq * torch.exp(cum_excl - c)) @ (kq * torch.exp(c - cum)
                                               ).transpose(-1, -2)
        y_intra = torch.where(tril, a, 0.0) @ vq
        y_diag = (rq * uu * kq).sum(-1, keepdim=True) * vq
        outs.append(y_state + y_intra + y_diag)
        k_dec = kq * torch.exp(last - cum)
        state = torch.exp(last).transpose(-1, -2) * state + \
            k_dec.transpose(-1, -2) @ vq
    out = torch.cat(outs, dim=2)
    if return_states:
        return out, state, torch.stack(states, 2)
    return out, state


def wkv_chunked_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_w: torch.Tensor, u: torch.Tensor,
                        states: torch.Tensor, dout: torch.Tensor,
                        dstate: Optional[torch.Tensor] = None, *,
                        chunk: int = 64):
    """The gradients ``(dr, dk, dv, dlog_w, du, dstate0)`` of
    ``wkv_chunked_ref``'s (out, final state) against ``(dout, dstate)``
    (``dstate`` None for a zero gradient of the final state), by the
    explicit formulas (no autograd), float32 inside.  ``states`` is the
    forward's state entering each chunk (``return_states``).

    Per chunk, walked in reverse with the state's gradient ``G`` (that of
    the state the chunk writes) carried, with cum, ce = cum - log w, L =
    cum_last and the forward's centring c = L / 2, r' = r e^{ce - c},
    k' = k e^{c - cum}, A = (r' k'^T) strictly below the diagonal and
    the bonus ru = r . (u k):
      dA = (dO v^T) strictly below, dru = rowsum(dO * v),
      dv = A^T dO + ru dO + k' (e^c G),
      dr = e^{ce - c} (dA k' + dO (e^c S)^T) + dru u k,
      dk = e^{c - cum} (dA^T r' + v (e^c G)^T) + dru u r,
      du = sum over batch and steps of dru r k,
      G <- e^L G + e^c (r'^T dO)   (the gradient of the entering state),
    and log w's, through ce = cum - log w and L: with gce = r' (dA k' +
    dO (e^c S)^T) and gcum = -k' (dA^T r' + v (e^c G)^T), dlog_w[t] =
    sum_{t' > t} gce[t'] + sum_{t' >= t} gcum[t'] + gL, where gL = sum_j
    S G e^L + sum_s k' (v (e^c G)^T) is the same for every step of the
    chunk (the centring cancels from A, so c takes no gradient).
    Returns dr, dk, dv contiguous in the dtypes of r, k, v; dlog_w
    ``[B, H, S, D]``, du ``[H, D]`` and dstate0 ``[B, H, D, D]``
    float32."""
    b, h, s, d = r.shape
    if s % chunk:
        raise ValueError(f"wkv_chunked_bwd_ref: S={s} is not a multiple of "
                         f"chunk={chunk}")
    uu = u.float()[None, :, None, :]
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=r.device).tril(-1)
    g = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if dstate is None else dstate.float())
    grads = {name: [] for name in ("dr", "dk", "dv", "dw")}
    du = torch.zeros((b, h, d), dtype=torch.float32, device=r.device)
    for ci in reversed(range(s // chunk)):
        c0 = ci * chunk
        rq, kq, vq, wq, go = (x[:, :, c0:c0 + chunk].float()
                              for x in (r, k, v, log_w, dout))
        st = states[:, :, ci].float()
        cum = wq.cumsum(2)
        ce = cum - wq
        last = cum[:, :, -1:]                             # [B,H,1,D]
        c = last * 0.5
        er, ek = torch.exp(ce - c), torch.exp(c - cum)
        rp, kp = rq * er, kq * ek
        ec = torch.exp(c).transpose(-1, -2)               # [B,H,D,1]
        a = torch.where(tril, rp @ kp.transpose(-1, -2), 0.0)
        da = torch.where(tril, go @ vq.transpose(-1, -2), 0.0)
        dru = (go * vq).sum(-1, keepdim=True)             # [B,H,C,1]
        ru = (rq * uu * kq).sum(-1, keepdim=True)
        g_c = ec * g                                      # e^c G
        dv = a.transpose(-1, -2) @ go + ru * go + kp @ g_c
        dr_dec = da @ kp + go @ (ec * st).transpose(-1, -2)
        dk_state = vq @ g_c.transpose(-1, -2)
        dk_dec = da.transpose(-1, -2) @ rp + dk_state
        gce, gcum = rp * dr_dec, -kp * dk_dec
        gl = (torch.exp(last).transpose(-1, -2) * st * g).sum(-1)[:, :, None]
        gl = gl + (kp * dk_state).sum(2, keepdim=True)    # [B,H,1,D]
        suffix = gcum.flip(2).cumsum(2).flip(2) + \
            gce.flip(2).cumsum(2).flip(2) - gce
        grads["dw"].append(suffix + gl)
        grads["dr"].append(er * dr_dec + dru * uu * kq)
        grads["dk"].append(ek * dk_dec + dru * uu * rq)
        grads["dv"].append(dv)
        du += (dru * rq * kq).sum(2)
        g = torch.exp(last).transpose(-1, -2) * g + \
            ec * (rp.transpose(-1, -2) @ go)
    dr, dk, dv, dw = (torch.cat(grads[n][::-1], dim=2)
                      for n in ("dr", "dk", "dv", "dw"))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du.sum(0),
            g)


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            log_w: torch.Tensor, u: torch.Tensor, head_dim: int,
            state0: Optional[torch.Tensor] = None):
    """Sequential (step-by-step) WKV6 recurrence, the gold semantics of
    ``repro/kernels/ref.py::wkv_ref``: r/k/v ``[B, S, D]`` (D = H *
    head_dim), log_w ``[B, S, D]`` float32, u ``[D]``.  Returns (out
    ``[B, S, D]`` float32, final state ``[B, H, dk, dv]`` float32)."""
    b, s, d = r.shape
    h = d // head_dim
    rr, kk, vv = (x.float().reshape(b, s, h, head_dim) for x in (r, k, v))
    ww = torch.exp(log_w.float()).reshape(b, s, h, head_dim)
    uu = u.float().reshape(h, head_dim)
    state = (torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32,
                         device=r.device) if state0 is None else state0)
    outs = []
    for t in range(s):
        kv = torch.einsum("bhk,bhv->bhkv", kk[:, t], vv[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", rr[:, t],
                                 state + uu[None, :, :, None] * kv))
        state = ww[:, t][..., None] * state + kv
    return torch.stack(outs, 1).reshape(b, s, d), state
