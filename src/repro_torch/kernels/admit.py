"""Launch wrappers of the scheduler's three admission scans
(``csrc/admit.cu``), one launch per tick each.

They replace the ``lax.scan`` steps of ``repro/sched/scheduler.py``:
``ppcc_admit`` that of ``ppcc_tick``, ``twopl_admit`` that of
``twopl_tick`` and ``occ_admit`` that of ``occ_tick``.  A loop over the
transactions in torch would cost some ten launches per transaction; here
the transactions are walked in order on the card.  ``ppcc_admit`` issues
three device kernels a call (pack ``raw`` into words, the scan with its
sets in the registers of four warps, ``prec`` in one pass),
``twopl_admit`` and ``occ_admit`` two (pack one row of words a
transaction, ``raw | raw^T | ww`` for 2PL and ``raw | ww`` at and below
the diagonal's word for OCC, then one scan, shared, with one set); each
counts as one launch.  All three take n up to ``max_n``.  The plain
versions are ``kernels.ref.{ppcc,twopl,occ}_admit_ref``.

Each takes CUDA tensors only and raises on anything the kernel does not
take; ``kernels.ops`` is the dispatcher the scheduler calls.
``launches`` counts each wrapper's calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = {"ppcc_admit": 0, "twopl_admit": 0, "occ_admit": 0}

_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = build.load("admit")
        ppcc = lib.ppcc_admit_launch
        ppcc.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 9
        ppcc.restype = ctypes.c_int
        for fn in (lib.admit_max_n, lib.admit_row_words):
            fn.restype = ctypes.c_int
        lib.admit_max_n.argtypes = []
        lib.admit_row_words.argtypes = [ctypes.c_int]
        twopl = lib.twopl_admit_launch
        twopl.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 3
        twopl.restype = ctypes.c_int
        occ = lib.occ_admit_launch
        occ.argtypes = twopl.argtypes
        occ.restype = ctypes.c_int
        _fns = {"ppcc_admit": ppcc, "twopl_admit": twopl, "occ_admit": occ,
                "packed_max_n": lib.admit_max_n(),
                "row_words": lib.admit_row_words}
    return _fns


def max_n(name: str) -> int:
    """The largest n the scan ``name`` takes, the same for all three: their
    sets as packed words, 16 a thread of a CTA of 512 (262,144)."""
    if name not in launches:
        raise KeyError(f"no admission scan named {name!r}")
    return _launchers()["packed_max_n"]


def _check(name, raw, others, valid):
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {dev}")
    if raw.dim() != 2 or raw.shape[0] != raw.shape[1]:
        raise ValueError(f"{name}: raw must be [n, n], got "
                         f"{tuple(raw.shape)}")
    n = raw.shape[0]
    if n > max_n(name):
        raise ValueError(f"{name}: n={n}; it takes at most {max_n(name)}")
    build.check_arg(name, "raw", raw, torch.bool, (n, n), dev)
    for arg, t in others:
        build.check_arg(name, arg, t, torch.bool, (n, n), dev)
    build.check_arg(name, "valid", valid, torch.bool, (n,), dev)
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
    n, dev = _check("ppcc_admit", raw, (), valid)
    build.check_arg("ppcc_admit", "seq", seq, torch.int32, (n,), dev)
    admitted = torch.empty(n, dtype=torch.bool, device=dev)
    preceding = torch.empty_like(admitted)
    preceded = torch.empty_like(admitted)
    prec = torch.empty((n, n), dtype=torch.bool, device=dev)
    if n:
        fns = _launchers()
        ws = fns["row_words"](n)
        # scratch: packed rows and columns of raw, the order with the
        # valid bits, the three packed sets
        rows = torch.empty((n, ws), dtype=torch.int32, device=dev)
        cols = torch.empty_like(rows)
        steps = torch.empty(-(-n // 4) * 4, dtype=torch.int32, device=dev)
        bits = torch.empty(3 * ws, dtype=torch.int32, device=dev)
        _run("ppcc_admit", fns["ppcc_admit"](
            raw.data_ptr(), valid.data_ptr(), seq.data_ptr(), n,
            rows.data_ptr(), cols.data_ptr(), steps.data_ptr(),
            bits.data_ptr(), admitted.data_ptr(), preceding.data_ptr(),
            preceded.data_ptr(), prec.data_ptr(), _stream(dev)))
    return admitted, preceding, preceded, prec


def _greedy(name, raw, ww, valid):
    """``twopl_admit`` or ``occ_admit``: the pack and the shared scan."""
    n, dev = _check(name, raw, (("ww", ww),), valid)
    admitted = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        fns = _launchers()
        # scratch: the packed rows the scan tests
        rows = torch.empty((n, fns["row_words"](n)), dtype=torch.int32,
                           device=dev)
        _run(name, fns[name](
            raw.data_ptr(), ww.data_ptr(), valid.data_ptr(), n,
            rows.data_ptr(), admitted.data_ptr(), _stream(dev)))
    return admitted


def twopl_admit(raw, ww, valid):
    """2PL admission of one tick in index order: ``admitted bool[n]``,
    bit-equal to ``ref.twopl_admit_ref``."""
    return _greedy("twopl_admit", raw, ww, valid)


def occ_admit(raw, ww, valid):
    """OCC backward validation of one tick in index order:
    ``survivors bool[n]``, bit-equal to ``ref.occ_admit_ref``."""
    return _greedy("occ_admit", raw, ww, valid)
