"""Launch wrappers of the scheduler's three admission scans
(``csrc/admit.cu``), one launch per tick each.

They replace the ``lax.scan`` steps of ``repro/sched/scheduler.py``:
``ppcc_admit`` that of ``ppcc_tick``, ``twopl_admit`` that of
``twopl_tick`` and ``occ_admit`` that of ``occ_tick``.  A loop over the
transactions in torch would cost some ten launches per transaction; here
one CTA walks them in order.  The plain versions are
``kernels.ref.{ppcc,twopl,occ}_admit_ref``.

Each takes CUDA tensors only and raises on anything the kernel does not
take; ``kernels.ops`` is the dispatcher the scheduler calls.  The
wrappers make the transposed copy of ``raw`` that the kernels read
columns from.  ``launches`` counts each wrapper's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

SMEM_MAX = 232_448           # bytes of shared memory one CTA may use (H100)
launches = {"ppcc_admit": 0, "twopl_admit": 0, "occ_admit": 0}

_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = build.load("admit")
        ppcc = lib.ppcc_admit_launch
        ppcc.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 5
        ppcc.restype = ctypes.c_int
        twopl = lib.twopl_admit_launch
        twopl.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 2
        twopl.restype = ctypes.c_int
        occ = lib.occ_admit_launch
        occ.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 2
        occ.restype = ctypes.c_int
        _fns = {"ppcc_admit": ppcc, "twopl_admit": twopl, "occ_admit": occ}
    return _fns


def _check(name, raw, others, valid, per_txn_bytes):
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {dev}")
    if raw.dim() != 2 or raw.shape[0] != raw.shape[1]:
        raise ValueError(f"{name}: raw must be [n, n], got "
                         f"{tuple(raw.shape)}")
    n = raw.shape[0]
    build.check_arg(name, "raw", raw, torch.bool, (n, n), dev)
    for arg, t in others:
        build.check_arg(name, arg, t, torch.bool, (n, n), dev)
    build.check_arg(name, "valid", valid, torch.bool, (n,), dev)
    if n * per_txn_bytes > SMEM_MAX:
        raise ValueError(f"{name}: n={n} does not fit one CTA")
    return n, dev


def _run(name, rc):
    if rc:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ppcc_admit(raw, valid, seq):
    """PPCC admission of one tick in the order ``seq`` (``int32[n]``, a
    permutation); ``raw`` has its diagonal cleared.  Returns
    ``(admitted, preceding, preceded, prec[n, n])``, bit-equal to
    ``ref.ppcc_admit_ref``."""
    n, dev = _check("ppcc_admit", raw, (), valid, 3)
    build.check_arg("ppcc_admit", "seq", seq, torch.int32, (n,), dev)
    admitted = torch.empty(n, dtype=torch.bool, device=dev)
    preceding = torch.empty_like(admitted)
    preceded = torch.empty_like(admitted)
    prec = torch.zeros((n, n), dtype=torch.bool, device=dev)
    if n:
        raw_t = raw.t().contiguous()
        _run("ppcc_admit", _launchers()["ppcc_admit"](
            raw.data_ptr(), raw_t.data_ptr(), valid.data_ptr(),
            seq.data_ptr(), n, admitted.data_ptr(), preceding.data_ptr(),
            preceded.data_ptr(), prec.data_ptr(), _stream(dev)))
    return admitted, preceding, preceded, prec


def twopl_admit(raw, ww, valid):
    """2PL admission of one tick in index order: ``admitted bool[n]``,
    bit-equal to ``ref.twopl_admit_ref``."""
    n, dev = _check("twopl_admit", raw, (("ww", ww),), valid, 1)
    admitted = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        raw_t = raw.t().contiguous()
        _run("twopl_admit", _launchers()["twopl_admit"](
            raw.data_ptr(), raw_t.data_ptr(), ww.data_ptr(),
            valid.data_ptr(), n, admitted.data_ptr(), _stream(dev)))
    return admitted


def occ_admit(raw, ww, valid):
    """OCC backward validation of one tick in index order:
    ``survivors bool[n]``, bit-equal to ``ref.occ_admit_ref``."""
    n, dev = _check("occ_admit", raw, (("ww", ww),), valid, 1)
    survivors = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _run("occ_admit", _launchers()["occ_admit"](
            raw.data_ptr(), ww.data_ptr(), valid.data_ptr(), n,
            survivors.data_ptr(), _stream(dev)))
    return survivors
