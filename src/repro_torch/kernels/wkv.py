"""Launch wrapper of the chunked WKV kernel (``csrc/wkv.cu``).

``wkv_chunked`` replaces ``repro/kernels/wkv.py::wkv_chunked``
(``_wkv_kernel``): the chunked RWKV6 WKV with the float32 ``[D, D]``
state carried across chunks of any size from 1 to 128 (the model uses
128, the TPU wrapper's default is 64).  It also takes an initial state
and writes the final one, which the model's ``rwkv.wkv_chunked``
returns.  Head sizes D in {16, 32, 64}.

r/k/v ``[B, H, S, D]`` (float32 or bf16, one dtype) and log_w ``[B, H,
S, D]`` (float32) may be strided views: the model passes its ``[B, S,
H*D]`` tensors as ``[B, H, S, D]`` views, and the kernel reads them
through their strides; only the last axis must be contiguous.  u is
``[H, D]`` float32.  The output is a float32 ``[B, H, S, D]`` view of a
``[B, S, H, D]`` tensor, so the model reshapes it back without a copy;
the state is a contiguous float32 ``[B, H, D, D]``.  The plain version
is ``ref.wkv_chunked_ref``.  ``launches`` counts launches, and nothing
else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = {"wkv_chunked": 0}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("wkv").wkv_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 15
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def wkv_chunked(r, k, v, log_w, u, *, chunk: int = 64, state0=None):
    """One launch -> (out float32 ``[B, H, S, D]``, final state float32
    ``[B, H, D, D]``)."""
    name = "wkv_chunked"
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {dev}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, log_w)):
        raise ValueError(f"{name}: r, k, v, log_w must be one [B, H, S, D] "
                         f"shape, got {[tuple(t.shape) for t in (r, k, v, log_w)]}")
    b, h, s, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: D={d} is not one of {HEAD_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"{name}: chunk={chunk} must lie in 1..{MAX_CHUNK} "
                         f"and divide S={s}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"{name}: r, k, v must share one dtype of "
                         f"{list(DTYPES)}, got {r.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if log_w.dtype != torch.float32:
        raise ValueError(f"{name}: log_w must be float32, got {log_w.dtype}")
    for arg, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w)):
        if t.device != dev or (t.numel() and t.stride(3) != 1):
            raise ValueError(f"{name}: {arg} must lie on {dev} with a "
                             f"contiguous last axis")
    build.check_arg(name, "u", u, torch.float32, (h, d), dev)
    if state0 is not None:
        build.check_arg(name, "state0", state0, torch.float32, (b, h, d, d),
                        dev)
    out = torch.empty((b, s, h, d), dtype=torch.float32,
                      device=dev).transpose(1, 2)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    if state.numel():
        strides = [x for t in (r, k, v, log_w, out) for x in t.stride()[:3]]
        rc = _launcher()(DTYPES[r.dtype], r.data_ptr(), k.data_ptr(),
                         v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
                         0 if state0 is None else state0.data_ptr(),
                         out.data_ptr(), state.data_ptr(), b, h, s, d, chunk,
                         *strides, torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        launches[name] += 1
    return out, state
