"""Launch wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` replaces ``repro/kernels/flash_attention.py::
flash_attention`` (``_flash_kernel``): block-wise online-softmax
attention with GQA (query head h reads KV head h // (Hq / Hkv)), a
causal mask aligned top-left (query index >= key index, both from 0)
and a sliding window (query - key < window), float32 running max, sum
and accumulator, fully masked key blocks skipped.  Any Sq, Sk and
D <= 256, float32 or bf16, output in q's dtype.  A row with every key
masked is 0, as in the plain version ``ref.flash_attention_ref``.

q ``[B, Hq, Sq, D]`` and k/v ``[B, Hkv, Sk, D]`` may be strided views
(the model passes ``[B, S, H, D]`` tensors transposed); only the last
axis must be contiguous.  The output is a ``[B, Hq, Sq, D]`` view of a
``[B, Sq, Hq, D]`` tensor, so the model reshapes it back without a copy.
``launches`` counts launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_D = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = {"flash_attention": 0}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sm_scale: float = None):
    """One launch -> ``[B, Hq, Sq, D]`` attention output in q's dtype."""
    name = "flash_attention"
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q must be [B, Hq, Sq, D] and k, v one "
                         f"[B, Hkv, Sk, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, sk, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"{name}: batch and D must match and Hkv divide "
                         f"Hq, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{name}: D={d} is outside 1..{MAX_D}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share one dtype of "
                         f"{list(DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or (t.numel() and t.stride(3) != 1):
            raise ValueError(f"{name}: {arg} must lie on {dev} with a "
                             f"contiguous last axis")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    if out.numel():
        scale = float(sm_scale) if sm_scale is not None else d ** -0.5
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        rc = _launcher()(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, sk, d,
                         *strides, int(causal), int(window), scale,
                         torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        launches[name] += 1
    return out
