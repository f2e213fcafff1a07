"""Launch wrappers of the cohort-step megakernel (``csrc/megastep.cu``)
and the row-slab kernel (``csrc/rowslab.cu``).

``megastep`` replaces ``repro/kernels/megastep.py::_megastep_kernel``:
one launch computes every pairwise relation of a fused PPCC cohort step
for all lanes of a fleet, each lane split over CTAs of 96 rows, with the
lane's packed words and op data resident in shared memory, the party
matrix packed to bits there, and the four tables written 16 bytes a
store.  ``rowslab_drain`` and ``rowslab`` replace
``_rowslab_kernel``.  The drain, which the delta engine launches once per
PPCC iteration, takes each lane's dirty mask and writes the next
iteration's four relation tables, out of place: the dirty slots' rows
and mirrored columns recomputed, every other entry copied.  ``rowslab``
is the reference's slab API: for K slot ids of every lane it recomputes
only their relation rows, against the carried op tables with the fresh
slab rows substituted.  Their plain versions are
``kernels.ref.megastep_ref``, ``kernels.ref.rowslab_drain_ref`` and
``kernels.ref.rowslab_ref``; each source file states its kernels' byte
bounds, design and shared-memory footprint.

All three take CUDA tensors only and raise on anything their kernel does
not take; ``kernels.ops`` holds the dispatchers the engine calls.
``launches`` counts launches of each kernel, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

SMEM_MAX = 232_448           # bytes of shared memory one CTA may use (H100)
launches = {"megastep": 0, "rowslab": 0, "rowslab_drain": 0}

_fn = None
_slab_fn = None
_drain_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = build.load("megastep")
        fn = lib.megastep_launch
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.megastep_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.megastep_smem_bytes.restype = ctypes.c_longlong
        _fn = (fn, lib.megastep_smem_bytes)
    return _fn


def megastep_max_n(w: int) -> int:
    """The largest n whose footprint at W = ``w`` words fits one CTA's
    shared memory (0 if none does); the footprint grows with n."""
    smem_bytes = _launcher()[1]
    lo, hi = 0, 1
    while smem_bytes(hi, w) <= SMEM_MAX:
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if smem_bytes(mid, w) <= SMEM_MAX else (lo, mid)
    return lo


def megastep(read_bits, write_bits, dirty_bits, item, is_write, active,
             ready, haslocks):
    """One launch → ``(dep, ww, writers_at, readers_at, deg, lockhit,
    dirty_hit)`` for every lane, bit-equal to ``ref.megastep_ref``.

    Words are ``int32[L, n, W]``, ``item`` ``int32[L, n]``, flags
    ``bool[L, n]``, all contiguous on one CUDA device.  Outputs are
    allocated here with ``torch.empty`` and written whole by the kernel.
    """
    dev = read_bits.device
    if dev.type != "cuda":
        raise ValueError(f"megastep runs on CUDA tensors, got {dev}")
    lanes, n, w = read_bits.shape
    for name, t in (("read_bits", read_bits), ("write_bits", write_bits),
                    ("dirty_bits", dirty_bits)):
        build.check_arg("megastep", name, t, torch.int32, (lanes, n, w),
                        dev)
    build.check_arg("megastep", "item", item, torch.int32, (lanes, n), dev)
    for name, t in (("is_write", is_write), ("active", active),
                    ("ready", ready), ("haslocks", haslocks)):
        build.check_arg("megastep", name, t, torch.bool, (lanes, n), dev)
    fn, smem_bytes = _launcher()
    need = smem_bytes(n, w)
    if need > SMEM_MAX:
        raise ValueError(
            f"megastep: n={n}, W={w} needs {need} B of shared memory per "
            f"CTA, more than {SMEM_MAX}; at W={w} it takes n up to "
            f"{megastep_max_n(w)}")
    rel = [torch.empty((lanes, n, n), dtype=torch.bool, device=dev)
           for _ in range(4)]
    deg = torch.empty((lanes, n), dtype=torch.int32, device=dev)
    lockhit = torch.empty((lanes, n), dtype=torch.bool, device=dev)
    dirty_hit = torch.empty((lanes, n), dtype=torch.bool, device=dev)
    if lanes and n:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in (
            read_bits, write_bits, dirty_bits, item, is_write, active, ready,
            haslocks, *rel, deg, lockhit, dirty_hit)), lanes, n, w, stream)
        if rc:
            raise RuntimeError(f"megastep launch failed: cudaError {rc}")
        launches["megastep"] += 1
    return (*rel, deg, lockhit, dirty_hit)


def _slab_launcher():
    global _slab_fn
    if _slab_fn is None:
        lib = build.load("rowslab")
        fn = lib.rowslab_launch
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + \
            [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rowslab_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.rowslab_smem_bytes.restype = ctypes.c_longlong
        _slab_fn = (fn, lib.rowslab_smem_bytes)
    return _slab_fn


def rowslab(read_bits, write_bits, writers_at, readers_at, item, is_write,
            active, slab, valid):
    """One launch → ``(dep_rows, ww_rows, wat_rows, rat_rows)``, each
    ``bool[L, K, n]``, for every lane, bit-equal to ``ref.rowslab_ref``.

    Words are ``int32[L, n, W]``, ``item`` ``int32[L, n]``, flags
    ``bool[L, n]``, ``slab`` ``int32[L, K]`` and ``valid`` ``bool[L, K]``,
    contiguous on one CUDA device; the carried tables ``bool[L, n, n]``
    may be strided views (the engine's padded relation buffer) whose
    rows are contiguous, both with the same strides.  Outputs are
    allocated here and written whole by the kernel.
    """
    dev = read_bits.device
    if dev.type != "cuda":
        raise ValueError(f"rowslab runs on CUDA tensors, got {dev}")
    lanes, n, w = read_bits.shape
    k = slab.shape[-1]
    for name, t in (("read_bits", read_bits), ("write_bits", write_bits)):
        build.check_arg("rowslab", name, t, torch.int32, (lanes, n, w), dev)
    for name, t in (("writers_at", writers_at), ("readers_at", readers_at)):
        if t.device != dev or t.dtype != torch.bool or \
                tuple(t.shape) != (lanes, n, n) or t.stride() != \
                writers_at.stride() or (n > 1 and t.stride(2) != 1):
            raise ValueError(
                f"rowslab: {name} must be a torch.bool tensor of shape "
                f"{(lanes, n, n)} on {dev} with contiguous rows and the "
                f"strides of writers_at, got {t.dtype} {tuple(t.shape)} "
                f"strides {t.stride()} on {t.device}")
    build.check_arg("rowslab", "item", item, torch.int32, (lanes, n), dev)
    for name, t in (("is_write", is_write), ("active", active)):
        build.check_arg("rowslab", name, t, torch.bool, (lanes, n), dev)
    build.check_arg("rowslab", "slab", slab, torch.int32, (lanes, k), dev)
    build.check_arg("rowslab", "valid", valid, torch.bool, (lanes, k), dev)
    fn, smem_bytes = _slab_launcher()
    need = smem_bytes(n, w, k)
    if need > SMEM_MAX:
        raise ValueError(
            f"rowslab: n={n}, W={w}, K={k} needs {need} B of shared memory "
            f"per CTA, more than {SMEM_MAX}")
    rows = [torch.empty((lanes, k, n), dtype=torch.bool, device=dev)
            for _ in range(4)]
    if lanes and n and k:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in (
            read_bits, write_bits, writers_at, readers_at, item, is_write,
            active, slab, valid, *rows)), lanes, n, w, k,
            writers_at.stride(0), writers_at.stride(1), stream)
        if rc:
            raise RuntimeError(f"rowslab launch failed: cudaError {rc}")
        launches["rowslab"] += 1
    return tuple(rows)


def _drain_launcher():
    global _drain_fn
    if _drain_fn is None:
        lib = build.load("rowslab")
        fn = lib.rowslab_drain_launch
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rowslab_drain_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.rowslab_drain_smem_bytes.restype = ctypes.c_longlong
        _drain_fn = (fn, lib.rowslab_drain_smem_bytes)
    return _drain_fn


def rowslab_drain(read_bits, write_bits, dep, ww, writers_at, readers_at,
                  item, is_write, active, dirty):
    """One launch → the next iteration's ``(dep, ww, writers_at,
    readers_at)``, each a new ``bool[L, n, n]``, bit-equal to
    ``ref.rowslab_drain_ref``; the carried tables are only read.

    Words are ``int32[L, n, W]``, the carried tables ``bool[L, n, n]``,
    ``item`` ``int32[L, n]`` and ``is_write``/``active``/``dirty``
    ``bool[L, n]``, all contiguous on one CUDA device."""
    dev = read_bits.device
    if dev.type != "cuda":
        raise ValueError(f"rowslab_drain runs on CUDA tensors, got {dev}")
    lanes, n, w = read_bits.shape
    for name, t in (("read_bits", read_bits), ("write_bits", write_bits)):
        build.check_arg("rowslab_drain", name, t, torch.int32,
                        (lanes, n, w), dev)
    for name, t in (("dep", dep), ("ww", ww), ("writers_at", writers_at),
                    ("readers_at", readers_at)):
        build.check_arg("rowslab_drain", name, t, torch.bool, (lanes, n, n),
                        dev)
    build.check_arg("rowslab_drain", "item", item, torch.int32, (lanes, n),
                    dev)
    for name, t in (("is_write", is_write), ("active", active),
                    ("dirty", dirty)):
        build.check_arg("rowslab_drain", name, t, torch.bool, (lanes, n),
                        dev)
    fn, smem_bytes = _drain_launcher()
    need = smem_bytes(n, w)
    if need > SMEM_MAX:
        raise ValueError(
            f"rowslab_drain: n={n}, W={w} needs {need} B of shared memory "
            f"per CTA, more than {SMEM_MAX}")
    out = [torch.empty((lanes, n, n), dtype=torch.bool, device=dev)
           for _ in range(4)]
    if lanes and n:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in (
            read_bits, write_bits, dep, ww, writers_at, readers_at, item,
            is_write, active, dirty, *out)), lanes, n, w, stream)
        if rc:
            raise RuntimeError(f"rowslab_drain launch failed: cudaError {rc}")
        launches["rowslab_drain"] += 1
    return tuple(out)
