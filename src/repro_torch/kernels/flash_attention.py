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
With ``return_lse`` either route also writes each row's float32
logsumexp ``[B, Hq, Sq]`` (natural log of the scaled scores, -inf for a
wholly masked row); without it the kernels write the output alone, as
the prefill has always called them.

``flash_attention_bwd`` is the backward (``csrc/flash_attention_bwd.cu``,
float32 accumulation): from q, k, v, the forward's output and lse and
the output's gradient it computes dq, dk, dv, deterministically (no
atomics), dk and dv summed over each KV head's query heads; it replaces
XLA's autodiff of the reference's attention, not a TPU kernel.  Its
route is picked by dtype and D in plain code (``bwd_route``), and no
route stands in for another: bf16 at D <= 128 runs on the tensor cores
(``flash_attention_bwd_tc``: wgmma, with q, k, v and dout brought in by
TMA where all four pass ``tma_strides``, else staged by the kernels'
producer warps); bf16 at 128 < D <= 256 on the CUDA cores
(``flash_attention_bwd_wide``: a warpgroup's two 64 x D float32
accumulators would not fit its registers, and no model has such a D);
float32 on the CUDA cores (``flash_attention_bwd``), where the float32
train golden holds it to 1e-4.  It reads strided inputs (``dout`` may
come with any strides; only its last axis is made contiguous) and
writes dq, dk, dv in the layouts of q, k, v (``torch.empty_like``), so
the model's transposes cost no copy.  ``launches`` counts the launches
of each forward route and of each backward route (one count for its
three device kernels), and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_D = 256
ROUTES = {torch.float32: "flash_attention",       # CUDA cores
          torch.bfloat16: "flash_attention_tc"}   # tensor cores
BWD = "flash_attention_bwd"              # float32: CUDA cores
BWD_TC = "flash_attention_bwd_tc"        # bf16, D <= 128: tensor cores
BWD_WIDE = "flash_attention_bwd_wide"    # bf16, D > 128: CUDA cores
TC_BWD_MAX_D = 128
launches = {name: 0 for name in (*ROUTES.values(), BWD, BWD_TC, BWD_WIDE)}

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
                       + [ctypes.c_void_p, ctypes.c_void_p])
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


def _check(name, q, k, v):
    """Raise unless q ``[B, Hq, Sq, D]`` and k/v ``[B, Hkv, Sk, D]`` are
    CUDA tensors of one routed dtype with a contiguous last axis."""
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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sm_scale: float = None, return_lse: bool = False):
    """One launch -> ``[B, Hq, Sq, D]`` attention output in q's dtype, and
    with ``return_lse`` the float32 ``[B, Hq, Sq]`` row logsumexp."""
    name = "flash_attention"
    _check(name, q, k, v)
    dev = q.device
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    lse = torch.empty((b, hq, sq), dtype=torch.float32,
                      device=dev) if return_lse else None
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
                              None if lse is None else lse.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name} ({route}) launch failed: "
                               + ("TMA descriptor encoding failed"
                                  if rc == -1 else f"cudaError {rc}"))
        launches[route] += 1
    return (out, lse) if return_lse else out


_bwd_fn = None


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load(BWD).flash_attention_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def bwd_route(dtype, d: int) -> str:
    """The backward's route for q's dtype and head size D: bf16 on the
    tensor cores up to ``TC_BWD_MAX_D``, on the CUDA cores above it;
    float32 on the CUDA cores."""
    if dtype == torch.bfloat16:
        return BWD_TC if d <= TC_BWD_MAX_D else BWD_WIDE
    return BWD


def bwd_scratch_len(route: str, b: int, hq: int, sq: int) -> int:
    """float32 elements of the backward's scratch: delta on the CUDA-core
    routes; delta and lse * log2(e), rows padded to 64, on the tensor
    cores."""
    if route == BWD_TC:
        return 2 * b * hq * (-(-sq // 64) * 64)
    return b * hq * sq


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, sm_scale: float = None):
    """One launch (three device kernels) -> ``(dq, dk, dv)`` in the dtypes
    and layouts of q, k, v: the gradients of ``flash_attention``'s output
    ``out`` (``[B, Hq, Sq, D]``, any strides) with row logsumexp ``lse``
    (float32 ``[B, Hq, Sq]``) against the output gradient ``dout``, on
    ``bwd_route(q.dtype, D)``."""
    name = BWD
    _check(name, q, k, v)
    dev = q.device
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    for arg, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != dev or \
                t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg} must be a {q.dtype} "
                             f"{tuple(q.shape)} tensor on {dev} with a "
                             f"contiguous last axis")
    build.check_arg(name, "lse", lse, torch.float32, (b, hq, sq), dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not (q.numel() and k.numel()):
        return dq.zero_(), dk.zero_(), dv.zero_()
    route = bwd_route(q.dtype, d)
    delta = torch.empty(bwd_scratch_len(route, b, hq, sq),
                        dtype=torch.float32, device=dev)
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    views = [tma_strides(t) for t in (q, k, v, out, dout, dq, dk, dv)]
    strides = (ctypes.c_longlong * 24)(*(s for st, _ in views for s in st))
    tma = all(views[i][1] for i in (0, 1, 2, 4))     # q, k, v, dout
    rc = _bwd_launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), b, hq, hkv, sq, sk, d, strides,
                         int(causal), int(window), scale,
                         int(q.dtype == torch.bfloat16),
                         int(route == BWD_TC), int(tma),
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"{name} ({route}) launch failed: "
                           + ("TMA descriptor encoding failed"
                              if rc == -1 else f"cudaError {rc}"))
    launches[route] += 1
    return dq, dk, dv
