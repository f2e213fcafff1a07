"""Launch wrappers of the scheduler's conflict kernels (``csrc/conflict.cu``):
two routes, three entry points.

``conflict_matrix`` replaces ``repro/kernels/conflict.py::conflict_matrix``
(raw only), ``conflict_fused`` its ``conflict_fused`` (raw, ww and both
row degrees) and ``conflict_fused_full`` its ``conflict_fused_full`` (plus
raw's column degrees and both diagonals).  Any n >= 1 and any W; the
plain versions are ``kernels.ref.conflict_*_ref``, and the source file
states the kernels' bound and design.

``conflict_matrix`` takes the dense route: one kernel of 64 x 64 tiles,
one LOP3 per word pair.  The two fused entries issue a memset and four
device kernels a call: a count pass marks each row's nonzero words and
counts the set bits; then the scatter (which builds the page-major
bitsets ``writers`` and ``readers``), the dense kernel and the gather
kernel (a warp per row ORs the index rows of the row's set bits) all
launch and read the count on the device, and those of the route the
count does not choose exit at once.  No host read.  The scratch comes
from torch's caching allocator on the current stream.  ``routed`` and
``route_ran`` let tests and measurements force a route and see which
one ran.

Each takes contiguous ``int32[N, W]`` words on one CUDA device and raises
on anything else; ``kernels.ops`` is the dispatcher the scheduler calls.
``launches`` counts each entry point's calls, one a call, and nothing
else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_N = 65_535 * 64          # grid rows of the dense route's 64-row tiles
MODES = {"conflict_matrix": 0, "conflict_fused": 1, "conflict_fused_full": 2}
ROUTES = {None: -1, "dense": 0, "gather": 1}
launches = {name: 0 for name in MODES}

_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = build.load("conflict")
        fn = lib.conflict_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int] + [ctypes.c_void_p] * 8
        fn.restype = ctypes.c_int
        words = lib.conflict_scratch_words
        words.argtypes = [ctypes.c_int] * 3
        words.restype = ctypes.c_longlong
        lib.conflict_gather_cost.argtypes = []
        lib.conflict_gather_cost.restype = ctypes.c_double
        _fns = fn, words, lib.conflict_gather_cost()
    return _fns


def gather_cost() -> float:
    """The route rule's constant: the fused entries take the gather route
    when (set bits visited) x ceil(n/32) x gather_cost() <= 2 n^2 W."""
    return _launchers()[2]


def _launch(name: str, read_bits, write_bits, route=None):
    """Check the words, allocate the outputs of entry point ``name`` and
    launch; returns the seven output slots (unused ones ``None``) and the
    scratch.  ``route`` forces the fused entries' ``"dense"`` or
    ``"gather"`` route (both bit-equal; the tests hold each); ``None``
    lets the card choose, as the entry points do."""
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
    if route not in ROUTES or (route is not None and mode == 0):
        raise ValueError(f"{name}: route={route!r} is not one it takes")

    def bools(shape):
        return torch.empty(shape, dtype=torch.bool, device=dev)

    def degree():
        return torch.empty(n, dtype=torch.int32, device=dev)

    raw = bools((n, n))
    ww = bools((n, n)) if mode >= 1 else None
    rdeg = degree() if mode >= 1 else None
    wdeg = degree() if mode >= 1 else None
    cdeg = degree() if mode == 2 else None
    dr = bools(n) if mode == 2 else None
    dw = bools(n) if mode == 2 else None
    index = None
    if n:
        fn, scratch_words, _ = _launchers()
        index = torch.empty(max(1, scratch_words(mode, n, w)),
                            dtype=torch.int32, device=dev)
        ptrs = [None if t is None else t.data_ptr()
                for t in (raw, ww, rdeg, cdeg, wdeg, dr, dw)]
        rc = fn(mode, read_bits.data_ptr(), write_bits.data_ptr(), n, w,
                index.data_ptr(), ROUTES[route], *ptrs,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        launches[name] += 1
    return (raw, ww, rdeg, cdeg, wdeg, dr, dw), index


def routed(name: str, read_bits, write_bits, route=None):
    """For tests and measurements: the outputs of fused entry ``name`` on
    the route the card chooses, or on ``route`` (``"dense"`` or
    ``"gather"``) when given, and the scratch's route flags ``int32[2]``
    (gather ran, dense ran), left on the card."""
    outs, index = _launch(name, read_bits, write_bits, route)
    if name == "conflict_fused":
        outs = (outs[0], outs[1], outs[2], outs[4])
    return outs, index[2:4]


def route_ran(flags) -> str:
    """``"dense"`` or ``"gather"`` from ``routed``'s flags, read back with
    a host sync; raises unless exactly one route ran."""
    ran = flags.tolist()
    if sorted(ran) != [0, 1]:
        raise RuntimeError(f"route flags {ran}: not exactly one route ran")
    return "gather" if ran[0] else "dense"


def conflict_matrix(read_bits, write_bits):
    """``raw bool[N, N]``, bit-equal to ``ref.conflict_matrix_ref``."""
    return _launch("conflict_matrix", read_bits, write_bits)[0][0]


def conflict_fused(read_bits, write_bits):
    """``(raw, ww, raw_deg, ww_deg)`` in one call, bit-equal to
    ``ref.conflict_fused_ref``."""
    raw, ww, rdeg, _, wdeg, _, _ = _launch("conflict_fused", read_bits,
                                           write_bits)[0]
    return raw, ww, rdeg, wdeg


def conflict_fused_full(read_bits, write_bits):
    """``(raw, ww, raw_deg, war_deg, ww_deg, diag_raw, diag_ww)`` in one
    call, bit-equal to ``ref.conflict_fused_full_ref``."""
    return _launch("conflict_fused_full", read_bits, write_bits)[0]
