"""Launch wrapper of the cohort-step megakernel (``csrc/megastep.cu``).

The kernel replaces ``repro/kernels/megastep.py::_megastep_kernel``: one
launch computes every pairwise relation of a fused PPCC cohort step for
all lanes of a fleet, one CTA per lane, with the lane's packed words and
op data resident in shared memory and the party matrix packed to bits
there.  Its plain version is ``kernels.ref.megastep_ref``; the source
file states the kernel's byte bound and design.

``megastep`` takes CUDA tensors only and raises on anything the kernel
does not take; ``kernels.ops.megastep_relations`` is the dispatcher the
engine calls.  ``launches`` counts launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

SMEM_MAX = 232_448           # bytes of shared memory one CTA may use (H100)
launches = 0

_fn = None


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


def megastep(read_bits, write_bits, dirty_bits, item, is_write, active,
             ready, haslocks):
    """One launch → ``(dep, ww, writers_at, readers_at, deg, lockhit,
    dirty_hit)`` for every lane, bit-equal to ``ref.megastep_ref``.

    Words are ``int32[L, n, W]``, ``item`` ``int32[L, n]``, flags
    ``bool[L, n]``, all contiguous on one CUDA device.  Outputs are
    allocated here with ``torch.empty`` and written whole by the kernel.
    """
    global launches
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
            f"CTA, more than {SMEM_MAX}")
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
        launches += 1
    return (*rel, deg, lockhit, dirty_hit)
