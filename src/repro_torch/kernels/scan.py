"""Launch wrappers of the fleet body's two sequential scans
(``csrc/scan.cu``), one launch each.

``reserve_cohort`` replaces the XLA scan of
``repro/core/jaxsim.py::_reserve_cohort`` and ``occ_validate`` the OCC
same-iteration validation scan of ``jaxsim._cohort_body``.  A loop over
the slots in torch would cost one launch per slot and step.
``reserve_cohort`` walks each lane's CPU and disk pools as two chains,
one warp each, over the masked slots only, with the pool in registers;
``occ_validate`` walks one lane's would-be committers in one warp, the
accumulated write words in registers and the committers' rows copied
into shared memory a chunk ahead.  The plain
versions are ``kernels.ref.reserve_cohort_ref`` and
``kernels.ref.occ_validate_ref``.

Both take CUDA tensors only; ``kernels.ops`` is the dispatcher the
engine calls.  Each wrapper counts its launches in a plain integer.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import INF

launches = {"reserve_cohort": 0, "occ_validate": 0}

_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = build.load("scan")
        res = lib.reserve_cohort_launch
        res.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + \
            [ctypes.c_float, ctypes.c_void_p]
        res.restype = ctypes.c_int
        lib.reserve_cohort_max_pool.argtypes = []
        lib.reserve_cohort_max_pool.restype = ctypes.c_int
        occ = lib.occ_validate_launch
        occ.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        occ.restype = ctypes.c_int
        lib.occ_validate_max_words.argtypes = []
        lib.occ_validate_max_words.restype = ctypes.c_int
        _fns = (res, occ, lib.occ_validate_max_words(),
                lib.reserve_cohort_max_pool())
    return _fns


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def reserve_cohort(cpu_free, disk_free, t_req, cpu_dur, io_dur, cpu_m,
                   disk_m):
    """FCFS reservation of every lane's cohort in one launch: returns
    ``(cpu_free', disk_free', cpu_done[L, n], disk_done[L, n])``,
    bit-equal to ``ref.reserve_cohort_ref``."""
    dev = cpu_free.device
    if dev.type != "cuda":
        raise ValueError(f"reserve_cohort runs on CUDA tensors, got {dev}")
    lanes, nc = cpu_free.shape
    nd = disk_free.shape[1]
    n = t_req.shape[1]
    for name, t, dtype, shape in (
            ("cpu_free", cpu_free, torch.float32, (lanes, nc)),
            ("disk_free", disk_free, torch.float32, (lanes, nd)),
            ("t_req", t_req, torch.float32, (lanes, n)),
            ("cpu_dur", cpu_dur, torch.float32, (lanes, n)),
            ("io_dur", io_dur, torch.float32, (lanes, n)),
            ("cpu_m", cpu_m, torch.bool, (lanes, n)),
            ("disk_m", disk_m, torch.bool, (lanes, n))):
        build.check_arg("reserve_cohort", name, t, dtype, shape, dev)
    res, _, _, max_pool = _launchers()
    if nc < 1 or nd < 1 or max(nc, nd) > max_pool:
        raise ValueError(f"reserve_cohort: pools of {nc} CPUs and {nd} "
                         f"disks; it takes 1 to {max_pool} servers a pool")
    cpu_out = torch.empty_like(cpu_free)
    disk_out = torch.empty_like(disk_free)
    cpu_done = torch.empty_like(t_req)
    disk_done = torch.empty_like(t_req)
    if lanes:
        rc = res(*(t.data_ptr() for t in (
            cpu_free, disk_free, t_req, cpu_dur, io_dur, cpu_m, disk_m,
            cpu_out, disk_out, cpu_done, disk_done)), lanes, n, nc, nd, INF,
            _stream(dev))
        if rc:
            raise RuntimeError(f"reserve_cohort launch failed: "
                               f"cudaError {rc}")
        launches["reserve_cohort"] += 1
    return cpu_out, disk_out, cpu_done, disk_done


def occ_validate(commit_pre, read_bits, dirty_bits, write_bits):
    """OCC same-iteration validation of every lane in one launch: returns
    ``bool[L, n]`` failures, bit-equal to ``ref.occ_validate_ref``."""
    dev = read_bits.device
    if dev.type != "cuda":
        raise ValueError(f"occ_validate runs on CUDA tensors, got {dev}")
    lanes, n, w = read_bits.shape
    for name, t in (("read_bits", read_bits), ("dirty_bits", dirty_bits),
                    ("write_bits", write_bits)):
        build.check_arg("occ_validate", name, t, torch.int32, (lanes, n, w),
                        dev)
    build.check_arg("occ_validate", "commit_pre", commit_pre, torch.bool,
                    (lanes, n), dev)
    _, occ, max_words, _ = _launchers()
    if w > max_words:
        raise ValueError(f"occ_validate: rows of {w} words; it takes at "
                         f"most {max_words}")
    fail = torch.empty((lanes, n), dtype=torch.bool, device=dev)
    if lanes:
        rc = occ(*(t.data_ptr() for t in (
            commit_pre, read_bits, dirty_bits, write_bits, fail)),
            lanes, n, w, _stream(dev))
        if rc:
            raise RuntimeError(f"occ_validate launch failed: "
                               f"cudaError {rc}")
        launches["occ_validate"] += 1
    return fail
