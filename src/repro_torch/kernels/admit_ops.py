"""Launch wrapper of the PPCC op-list admission (``csrc/admit_ops.cu``),
one launch per call.

It replaces the ``lax.scan`` of ``repro/core/ppcc.py::admit_ops``: one
CTA per lane walks the lane's ops in order, its threads over the slots.
The plain version is ``kernels.ref.admit_ops_ref``.  The wrapper takes
CUDA tensors only and raises on anything the kernel does not take;
``kernels.ops.admit_ops`` is the dispatcher ``core.ppcc.admit_ops``
calls.  ``launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = {"admit_ops": 0}

_fns = None


def _launcher():
    global _fns
    if _fns is None:
        lib = build.load("admit_ops")
        fn = lib.admit_ops_launch
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 15
        fn.restype = ctypes.c_int
        lib.admit_ops_max_n.argtypes = []
        lib.admit_ops_max_n.restype = ctypes.c_int
        _fns = {"launch": fn, "max_n": lib.admit_ops_max_n()}
    return _fns


def max_n() -> int:
    """The largest n the kernel takes (32 slots a thread of a CTA of
    1,024)."""
    return _launcher()["max_n"]


def admit_ops(read_set, write_set, prec, preceding, preceded, active,
              haslocks, txn, item, is_write, valid):
    """Admit each lane's op list in order: ``(admitted, blocked, aborted)``
    ``bool[L, m]`` followed by the seven leaves of the new state, bit-equal
    to ``ref.admit_ops_ref``.  The state is copied and the kernel mutates
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
    if not 1 <= n <= max_n():
        raise ValueError(f"admit_ops: n={n}; it takes 1 to {max_n()}")
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
    state = [t.clone() for t in (read_set, write_set, prec, preceding,
                                 preceded)]
    verdicts = [torch.zeros((lanes, m), dtype=torch.bool, device=dev)
                for _ in range(3)]
    if lanes and m:
        rc = _launcher()["launch"](
            lanes, n, w, m, *(t.data_ptr() for t in state),
            active.data_ptr(), haslocks.data_ptr(), txn.data_ptr(),
            item.data_ptr(), is_write.data_ptr(), valid.data_ptr(),
            *(t.data_ptr() for t in verdicts),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"admit_ops launch failed: cudaError {rc}")
        launches["admit_ops"] += 1
    return (*verdicts, *state, active.clone(), haslocks.clone())
