"""Launch wrappers of the scheduler's conflict kernel (``csrc/conflict.cu``):
one CUDA template, three entry points.

``conflict_matrix`` replaces ``repro/kernels/conflict.py::conflict_matrix``
(raw only), ``conflict_fused`` its ``conflict_fused`` (raw, ww and both
row degrees) and ``conflict_fused_full`` its ``conflict_fused_full`` (plus
raw's column degrees and both diagonals).  Any n >= 1 and any W; the
plain versions are ``kernels.ref.conflict_*_ref``, and the source file
states the kernel's bound and design.

Each takes contiguous ``int32[N, W]`` words on one CUDA device and raises
on anything else; ``kernels.ops`` is the dispatcher the scheduler calls.
``launches`` counts each entry point's launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_N = 65_535 * 64          # grid rows of 64-transaction tiles
MODES = {"conflict_matrix": 0, "conflict_fused": 1, "conflict_fused_full": 2}
launches = {name: 0 for name in MODES}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("conflict").conflict_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(name: str, read_bits, write_bits):
    """Check the words, allocate the outputs of entry point ``name`` and
    launch; returns the seven output slots (unused ones ``None``)."""
    dev = read_bits.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {dev}")
    if read_bits.dim() != 2:
        raise ValueError(f"{name}: words must be [N, W], got "
                         f"{tuple(read_bits.shape)}")
    n, w = read_bits.shape
    for arg, t in (("read_bits", read_bits), ("write_bits", write_bits)):
        build.check_arg(name, arg, t, torch.int32, (n, w), dev)
    if n > MAX_N:
        raise ValueError(f"{name}: n={n} is above {MAX_N}")
    mode = MODES[name]

    def bools(shape):
        return torch.empty(shape, dtype=torch.bool, device=dev)

    def degree():
        return torch.zeros(n, dtype=torch.int32, device=dev)

    raw = bools((n, n))
    ww = bools((n, n)) if mode >= 1 else None
    rdeg = degree() if mode >= 1 else None
    wdeg = degree() if mode >= 1 else None
    cdeg = degree() if mode == 2 else None
    dr = bools(n) if mode == 2 else None
    dw = bools(n) if mode == 2 else None
    if n:
        ptrs = [None if t is None else t.data_ptr()
                for t in (raw, ww, rdeg, cdeg, wdeg, dr, dw)]
        rc = _launcher()(mode, read_bits.data_ptr(), write_bits.data_ptr(),
                         n, w, *ptrs,
                         torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        launches[name] += 1
    return raw, ww, rdeg, cdeg, wdeg, dr, dw


def conflict_matrix(read_bits, write_bits):
    """``raw bool[N, N]``, bit-equal to ``ref.conflict_matrix_ref``."""
    return _launch("conflict_matrix", read_bits, write_bits)[0]


def conflict_fused(read_bits, write_bits):
    """``(raw, ww, raw_deg, ww_deg)`` in one launch, bit-equal to
    ``ref.conflict_fused_ref``."""
    raw, ww, rdeg, _, wdeg, _, _ = _launch("conflict_fused", read_bits,
                                           write_bits)
    return raw, ww, rdeg, wdeg


def conflict_fused_full(read_bits, write_bits):
    """``(raw, ww, raw_deg, war_deg, ww_deg, diag_raw, diag_ww)`` in one
    launch, bit-equal to ``ref.conflict_fused_full_ref``."""
    raw, ww, rdeg, cdeg, wdeg, dr, dw = _launch("conflict_fused_full",
                                                read_bits, write_bits)
    return raw, ww, rdeg, cdeg, wdeg, dr, dw
