"""Dispatchers the engine calls for its kernels.

A CUDA tensor goes to the hand-written kernel (``kernels.megastep``,
``kernels.scan``), a CPU tensor to the kernel's plain version
(``kernels.ref``).  There is no fallback: a failed build or launch on
the card raises.  ``launch_counts`` reads the wrappers' launch counters
and ``reset_launches`` sets them to 0.
"""
from __future__ import annotations

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


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launches``."""
    return {"megastep": _megastep.launches, **_scan.launches}


def reset_launches() -> None:
    _megastep.launches = 0
    for k in _scan.launches:
        _scan.launches[k] = 0
