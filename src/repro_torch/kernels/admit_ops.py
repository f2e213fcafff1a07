"""Launch wrapper of the PPCC op-list admission (``csrc/admit_ops.cu``),
one host call per admission.

It replaces the ``lax.scan`` of ``repro/core/ppcc.py::admit_ops``: the
state is packed to bits (prec as bit rows and bit columns, the sets as
item-major bit columns, the flags as bit vectors) and one warp per lane
walks the lane's ops in order over those words.  ``route`` picks, in
plain Python from n and W, where the packed state lives: in the walking
CTA's shared memory (one device kernel a call) or in a scratch in device
memory (two packing kernels and the walk).  The plain version is
``kernels.ref.admit_ops_ref``.  The wrapper takes CUDA tensors only and
raises on anything the kernel does not take; ``kernels.ops.admit_ops`` is
the dispatcher ``core.ppcc.admit_ops`` calls.  ``launches`` counts host
calls that launched.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = {"admit_ops": 0}

SHARED, GLOBAL = "shared", "global"
ROUTES = (SHARED, GLOBAL)          # the source's route numbers, in order
SMEM_LIMIT = 232_448               # shared memory a block may use on sm_90
# the walk's flag words: haslocks, active, preceding, preceded and the
# step's new arcs, one word each per 32 slots, on either route
FLAG_WORDS = 5
MAX_N = 32 * (SMEM_LIMIT // (4 * FLAG_WORDS))
MAX_W = 2 ** 26 - 1                # items 32 W stay below 2**31

_fns = None


def _launcher():
    global _fns
    if _fns is None:
        lib = build.load("admit_ops")
        fn = lib.admit_ops_launch
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 17 + [
            ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.admit_ops_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.admit_ops_smem_bytes.restype = ctypes.c_longlong
        lib.admit_ops_scratch_words.argtypes = [ctypes.c_int] * 4
        lib.admit_ops_scratch_words.restype = ctypes.c_longlong
        _fns = {"launch": fn, "smem_bytes": lib.admit_ops_smem_bytes,
                "scratch_words": lib.admit_ops_scratch_words}
    return _fns


def words(n: int) -> int:
    """32-bit words of one packed row of n slots."""
    return -(-n // 32)


def stride(route: str, n: int) -> int:
    """Words between two packed rows: odd on the shared route (its
    transposes store to 32 banks), a multiple of 4 on the global route."""
    nw = words(n)
    return nw | 1 if route == SHARED else -(-nw // 4) * 4


def packed_words(route: str, n: int, w: int) -> int:
    """Words of one lane's packed state: P and PT (n rows each), R and WC
    (32 W item columns each)."""
    return (2 * n + 64 * w) * stride(route, n)


def smem_bytes(route: str, n: int, w: int) -> int:
    """Dynamic shared memory of the walk: the flag words, and on the
    shared route the whole packed state."""
    b = 4 * FLAG_WORDS * words(n)
    if route == SHARED:
        b += 4 * packed_words(route, n, w)
    return b


def scratch_words(route: str, lanes: int, n: int, w: int) -> int:
    """int32 words of the global route's scratch (none on the shared
    route)."""
    return lanes * packed_words(route, n, w) if route == GLOBAL else 0


def route(n: int, w: int) -> str:
    """The shared route where the packed state of n slots and W words of
    items fits in a block's shared memory, else the global route.  The op
    count m does not enter: the walk holds the ops in registers, a chunk
    of 32 ahead."""
    return SHARED if smem_bytes(SHARED, n, w) <= SMEM_LIMIT else GLOBAL


def shared_max_n(w: int) -> int:
    """The largest n the shared route takes at W words of items (0 where
    it takes none)."""
    lo, hi = 0, MAX_N
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if route(mid, w) == SHARED:
            lo = mid
        else:
            hi = mid - 1
    return lo


def device_bytes(lanes: int, n: int, w: int, m: int) -> int:
    """Device memory one call allocates: the copies of the sets and prec,
    the class flags out, the verdicts and the global route's scratch."""
    return (lanes * (2 * 4 * n * w + n * n + 2 * n) + 3 * lanes * m
            + 4 * scratch_words(route(n, w), lanes, n, w))


def admit_ops(read_set, write_set, prec, preceding, preceded, active,
              haslocks, txn, item, is_write, valid):
    """Admit each lane's op list in order: ``(admitted, blocked, aborted)``
    ``bool[L, m]`` followed by the seven leaves of the new state, bit-equal
    to ``ref.admit_ops_ref``.  The state is copied and the kernel updates
    the copy.  A valid op's ``txn`` and ``item`` must lie in ``[0, n)`` and
    ``[0, 32 W)`` (``core.ppcc.admit_ops`` checks; the kernel skips one
    that does not)."""
    dev = read_set.device
    if dev.type != "cuda":
        raise ValueError(f"admit_ops runs on CUDA tensors, got {dev}")
    if read_set.dim() != 3:
        raise ValueError(f"admit_ops: read_set must be [L, n, W], got "
                         f"{tuple(read_set.shape)}")
    lanes, n, w = read_set.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(
            f"admit_ops: n={n}; the walk keeps {FLAG_WORDS} words of shared "
            f"memory per 32 slots, so it takes 1 to {MAX_N}")
    if not 1 <= w <= MAX_W:
        raise ValueError(f"admit_ops: W={w}; item indices 32 W must stay "
                         f"below 2**31, so it takes 1 to {MAX_W}")
    if txn.dim() != 2 or txn.shape[0] != lanes:
        raise ValueError(f"admit_ops: txn must be [{lanes}, m], got "
                         f"{tuple(txn.shape)}")
    m = txn.shape[1]
    check = build.check_arg
    check("admit_ops", "read_set", read_set, torch.int32, (lanes, n, w), dev)
    check("admit_ops", "write_set", write_set, torch.int32, (lanes, n, w),
          dev)
    check("admit_ops", "prec", prec, torch.bool, (lanes, n, n), dev)
    for name, t in (("preceding", preceding), ("preceded", preceded),
                    ("active", active), ("haslocks", haslocks)):
        check("admit_ops", name, t, torch.bool, (lanes, n), dev)
    for name, t, dtype in (("txn", txn, torch.int32),
                           ("item", item, torch.int32),
                           ("is_write", is_write, torch.bool),
                           ("valid", valid, torch.bool)):
        check("admit_ops", name, t, dtype, (lanes, m), dev)
    need = device_bytes(lanes, n, w, m)
    total = torch.cuda.get_device_properties(dev).total_memory
    if need > total:
        raise ValueError(
            f"admit_ops: L={lanes}, n={n}, W={w}, m={m} needs {need} bytes "
            f"of device memory for its copies and packed state; the card "
            f"has {total}")
    sets_prec = [t.clone() for t in (read_set, write_set, prec)]
    if not (lanes and m):
        return (*(torch.zeros((lanes, m), dtype=torch.bool, device=dev)
                  for _ in range(3)), *sets_prec, preceding.clone(),
                preceded.clone(), active.clone(), haslocks.clone())
    flags = [torch.empty_like(preceding), torch.empty_like(preceded)]
    verdicts = [torch.empty((lanes, m), dtype=torch.bool, device=dev)
                for _ in range(3)]
    r = route(n, w)
    nscr = scratch_words(r, lanes, n, w)
    scratch = torch.empty(max(nscr, 1), dtype=torch.int32, device=dev)
    rc = _launcher()["launch"](
        ROUTES.index(r), lanes, n, w, m, *(t.data_ptr() for t in sets_prec),
        preceding.data_ptr(), preceded.data_ptr(),
        *(t.data_ptr() for t in flags), active.data_ptr(),
        haslocks.data_ptr(), txn.data_ptr(), item.data_ptr(),
        is_write.data_ptr(), valid.data_ptr(),
        *(t.data_ptr() for t in verdicts), scratch.data_ptr(), nscr,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"admit_ops launch failed: cudaError {rc}")
    launches["admit_ops"] += 1
    return (*verdicts, *sets_prec, *flags, active.clone(), haslocks.clone())
