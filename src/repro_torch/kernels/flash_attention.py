"""Launch wrapper of the flash-attention kernels (``csrc/flash_attention.cu``).

``flash_attention`` replaces ``repro/kernels/flash_attention.py::
flash_attention`` (``_flash_kernel``): block-wise online-softmax
attention with GQA (query head h reads KV head h // (Hq / Hkv)), a
causal mask aligned top-left (query index >= key index, both from 0)
and a sliding window (query - key < window), float32 running max, sum
and accumulator, fully masked key blocks skipped.  Any Sq, Sk and
D <= 256, output in q's dtype.  A row with every key masked is 0, as in
the plain version ``ref.flash_attention_ref``.

The dtype picks the route, and no route stands in for another: bf16
runs on the tensor cores (``flash_attention_tc_launch``: wgmma, with
K and V brought in by TMA where every base is 16-byte aligned and every
stride a multiple of 16 bytes, else staged by the kernel's producer
warps), float32 on the CUDA cores (``flash_attention_launch``), where
the port's float32 golden checks hold it to 1e-4.

q ``[B, Hq, Sq, D]`` and k/v ``[B, Hkv, Sk, D]`` may be strided views
(the model passes ``[B, S, H, D]`` tensors transposed); only the last
axis must be contiguous.  The output is a ``[B, Hq, Sq, D]`` view of a
``[B, Sq, Hq, D]`` tensor, so the model reshapes it back without a copy.
``launches`` counts the launches of each route, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_D = 256
ROUTES = {torch.float32: "flash_attention",       # CUDA cores
          torch.bfloat16: "flash_attention_tc"}   # tensor cores
launches = {name: 0 for name in ROUTES.values()}

_fns: dict = {}


def _launcher(route: str):
    fn = _fns.get(route)
    if fn is None:
        lib = build.load("flash_attention")
        tc = route == "flash_attention_tc"
        fn = lib.flash_attention_tc_launch if tc \
            else lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float] + [ctypes.c_int] * tc
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[route] = fn
    return fn


def tma_strides(t: torch.Tensor):
    """(batch, head, row) element strides of a ``[B, H, S, D]`` view, a
    size-1 axis given the whole view's extent (its stride is never
    stepped, and TMA wants every stride a multiple of 16 bytes), and
    whether TMA can load the view: a 16-byte-aligned base and strides
    that are multiples of 16 bytes."""
    per16 = 16 // t.element_size()
    extent = per16 * -(-t.numel() // per16)
    strides = [s if n > 1 else extent
               for s, n in zip(t.stride()[:3], t.shape[:3])]
    ok = t.data_ptr() % 16 == 0 and t.shape[3] % per16 == 0 and \
        all(s % per16 == 0 for s in strides)
    return strides, ok


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
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share one dtype of "
                         f"{list(ROUTES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or (t.numel() and t.stride(3) != 1):
            raise ValueError(f"{name}: {arg} must lie on {dev} with a "
                             f"contiguous last axis")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    if out.numel():
        route = ROUTES[q.dtype]
        scale = float(sm_scale) if sm_scale is not None else d ** -0.5
        views = [tma_strides(t) for t in (q, k, v, out)]
        strides = (ctypes.c_longlong * 12)(*(s for st, _ in views
                                             for s in st))
        tma = [int(all(ok for _, ok in views[:3]))] \
            if route == "flash_attention_tc" else []
        rc = _launcher(route)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), b, hq, hkv, sq, sk, d, strides,
                              int(causal), int(window), scale, *tma,
                              torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name} ({route}) launch failed: "
                               + ("TMA descriptor encoding failed"
                                  if rc == -1 else f"cudaError {rc}"))
        launches[route] += 1
    return out
