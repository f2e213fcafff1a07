"""Dispatchers the engine and the scheduler call for their kernels.

A CUDA tensor goes to the hand-written kernel (``kernels.megastep`` for
the megastep and row-slab kernels, ``kernels.scan``, ``kernels.conflict``,
``kernels.admit``), a CPU tensor to the kernel's plain version
(``kernels.ref``).  There is no fallback:
a failed build or launch on the card raises.  ``launch_counts`` reads
the wrappers' launch counters and ``reset_launches`` sets them to 0.
"""
from __future__ import annotations

from . import admit as _admit
from . import conflict as _conflict
from . import megastep as _megastep
from . import ref
from . import scan as _scan


def _route(t, name: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def megastep_relations(read_bits, write_bits, dirty_bits, item, is_write,
                       active, ready, haslocks):
    """Cohort-step megakernel: ``(dep, ww, writers_at, readers_at, deg,
    lockhit, dirty_hit)`` for every lane in one launch."""
    fn = _megastep.megastep if _route(read_bits, "megastep_relations") \
        else ref.megastep_ref
    return fn(read_bits, write_bits, dirty_bits, item, is_write, active,
              ready, haslocks)


def rowslab_relations(read_bits, write_bits, writers_at, readers_at, item,
                      is_write, active, slab, valid):
    """Row-slab kernel: ``(dep_rows, ww_rows, wat_rows, rat_rows)`` of
    the K slab slots of every lane in one launch."""
    fn = _megastep.rowslab if _route(read_bits, "rowslab_relations") \
        else ref.rowslab_ref
    return fn(read_bits, write_bits, writers_at, readers_at, item,
              is_write, active, slab, valid)


def reserve_cohort(cpu_free, disk_free, t_req, cpu_dur, io_dur, cpu_m,
                   disk_m):
    """FCFS reservation scan: ``(cpu_free', disk_free', cpu_done,
    disk_done)``."""
    fn = _scan.reserve_cohort if _route(cpu_free, "reserve_cohort") \
        else ref.reserve_cohort_ref
    return fn(cpu_free, disk_free, t_req, cpu_dur, io_dur, cpu_m, disk_m)


def occ_validate(commit_pre, read_bits, dirty_bits, write_bits):
    """OCC same-iteration validation scan: ``bool[L, n]`` failures."""
    fn = _scan.occ_validate if _route(read_bits, "occ_validate") \
        else ref.occ_validate_ref
    return fn(commit_pre, read_bits, dirty_bits, write_bits)


def conflict_matrix(read_bits, write_bits):
    """Scheduler conflict relation: ``raw bool[N, N]``."""
    fn = _conflict.conflict_matrix if _route(read_bits, "conflict_matrix") \
        else ref.conflict_matrix_ref
    return fn(read_bits, write_bits)


def conflict_fused(read_bits, write_bits):
    """``(raw, ww, raw_deg, ww_deg)`` in one launch."""
    fn = _conflict.conflict_fused if _route(read_bits, "conflict_fused") \
        else ref.conflict_fused_ref
    return fn(read_bits, write_bits)


def conflict_fused_full(read_bits, write_bits):
    """``(raw, ww, raw_deg, war_deg, ww_deg, diag_raw, diag_ww)`` in one
    launch."""
    fn = _conflict.conflict_fused_full \
        if _route(read_bits, "conflict_fused_full") \
        else ref.conflict_fused_full_ref
    return fn(read_bits, write_bits)


def ppcc_admit(raw, valid, seq):
    """PPCC admission scan: ``(admitted, preceding, preceded, prec)``."""
    fn = _admit.ppcc_admit if _route(raw, "ppcc_admit") \
        else ref.ppcc_admit_ref
    return fn(raw, valid, seq)


def twopl_admit(raw, ww, valid):
    """2PL admission scan: ``admitted bool[n]``."""
    fn = _admit.twopl_admit if _route(raw, "twopl_admit") \
        else ref.twopl_admit_ref
    return fn(raw, ww, valid)


def occ_admit(raw, ww, valid):
    """OCC validation scan: ``survivors bool[n]``."""
    fn = _admit.occ_admit if _route(raw, "occ_admit") \
        else ref.occ_admit_ref
    return fn(raw, ww, valid)


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launches``."""
    return {**_megastep.launches, **_scan.launches, **_conflict.launches,
            **_admit.launches}


def reset_launches() -> None:
    for counts in (_megastep.launches, _scan.launches, _conflict.launches,
                   _admit.launches):
        for k in counts:
            counts[k] = 0
