"""Launch wrappers of the chunked WKV kernel (``csrc/wkv.cu``) and its
backward (``csrc/wkv_bwd.cu``).

``wkv_chunked`` replaces ``repro/kernels/wkv.py::wkv_chunked``
(``_wkv_kernel``): the chunked RWKV6 WKV with the float32 ``[D, D]``
state carried across chunks of any size from 1 to 128 (the model uses
128, the TPU wrapper's default is 64).  It also takes an initial state
and writes the final one, which the model's ``rwkv.wkv_chunked``
returns.  Head sizes D in {16, 32, 64}.  Both dtypes take one kernel:
its chunk products run on the tensor cores at float32 accuracy (three
TF32 passes), a CTA per (batch, head, 32 value columns).

r/k/v ``[B, H, S, D]`` (float32 or bf16, one dtype) and log_w ``[B, H,
S, D]`` (float32) may be strided views: the model passes its ``[B, S,
H*D]`` tensors as ``[B, H, S, D]`` views, and the kernel reads them
through their strides; only the last axis must be contiguous.  u is
``[H, D]`` float32.  The output is a float32 ``[B, H, S, D]`` view of a
``[B, S, H, D]`` tensor, so the model reshapes it back without a copy;
the state is a contiguous float32 ``[B, H, D, D]``.  With
``return_states`` the forward also writes the state entering each chunk,
float32 ``[B, H, S / chunk, D, D]``, which the backward reads.

``wkv_chunked_bwd`` replaces no TPU kernel (the reference trains by XLA's
autodiff of the model's chunk scan): from the forward's inputs, its
states and the output's gradient (and, if any, the final state's, with
the forward's final state), one host call gives dr, dk, dv in the dtypes of r, k, v, and dlog_w, du and
dstate0 in float32.  It issues four device kernels (``BWD_KERNELS``):
each chunk's term of the state gradient's update, all chunks at once; the
state gradient of every chunk, a scan over the chunks in reverse; every
chunk's gradients at once from its saved state and its state gradient,
on the tensor cores (three TF32 passes); du's sum over the batch and the
chunks.  The wrapper allocates their float32 scratch: the state
gradients ``[B, H, S / chunk, D, D]`` (the size of the forward's saved
states) and three ``[B, H, S / chunk, D]``.  The plain versions are
``ref.wkv_chunked_ref`` and ``ref.wkv_chunked_bwd_ref``.  ``launches``
counts launches (host calls), and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD = "wkv_chunked_bwd"
# the backward's device kernels, in launch order
BWD_KERNELS = ("wkv_bwd_pstate", "wkv_bwd_dstate", "wkv_bwd_chunk",
               "wkv_du_sum")
launches = {"wkv_chunked": 0, BWD: 0}

_fns: dict = {}


def _launcher(name: str = "wkv"):
    """The C entry of library ``wkv`` (the forward) or ``wkv_bwd``."""
    fn = _fns.get(name)
    if fn is None:
        lib = build.load(name)
        if name == "wkv":
            fn = lib.wkv_launch
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                           + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 15
                           + [ctypes.c_void_p])
        else:
            fn = lib.wkv_bwd_launch
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 19
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _vec(*ts) -> bool:
    """Every pointer 16-byte aligned and every outer stride a multiple of
    8 elements: the kernels' vector loads."""
    return all(t.data_ptr() % 16 == 0 and not any(x % 8 for x in
                                                  t.stride()[:3])
               for t in ts)


def _check(name, r, k, v, log_w, u, chunk):
    """(b, h, s, d) of the forward's arguments, which both kernels take;
    raises on what they do not take."""
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
    return b, h, s, d


def bwd_occupancy(dtype, d: int) -> dict:
    """CTAs an SM of each of the backward's device kernels
    (``BWD_KERNELS``) at r/k/v ``dtype`` and head size ``d``, as the card
    reports them (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    fn = build.load("wkv_bwd").wkv_bwd_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(BWD_KERNELS))()
    rc = fn(DTYPES[dtype], d, ctypes.addressof(out))
    if rc:
        raise RuntimeError(f"wkv_bwd_occupancy failed: cudaError {rc}")
    return dict(zip(BWD_KERNELS, out))


def wkv_chunked(r, k, v, log_w, u, *, chunk: int = 64, state0=None,
                return_states: bool = False):
    """One launch -> (out float32 ``[B, H, S, D]``, final state float32
    ``[B, H, D, D]``), and with ``return_states`` the state entering each
    chunk, float32 ``[B, H, S / chunk, D, D]``."""
    name = "wkv_chunked"
    b, h, s, d = _check(name, r, k, v, log_w, u, chunk)
    dev = r.device
    if state0 is not None:
        build.check_arg(name, "state0", state0, torch.float32, (b, h, d, d),
                        dev)
    out = torch.empty((b, s, h, d), dtype=torch.float32,
                      device=dev).transpose(1, 2)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    states = torch.empty((b, h, s // chunk, d, d), dtype=torch.float32,
                         device=dev) if return_states else None
    if state.numel():
        strides = [x for t in (r, k, v, log_w, out) for x in t.stride()[:3]]
        vec = _vec(r, k, v, log_w)
        rc = _launcher()(DTYPES[r.dtype], r.data_ptr(), k.data_ptr(),
                         v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
                         0 if state0 is None else state0.data_ptr(),
                         out.data_ptr(), state.data_ptr(),
                         0 if states is None else states.data_ptr(), b, h, s,
                         d, chunk, int(vec), *strides,
                         torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        launches[name] += 1
    if return_states:
        return out, state, states
    return out, state


def wkv_chunked_bwd(r, k, v, log_w, u, states, dout, dstate=None,
                    state=None, *, chunk: int = 64):
    """One launch (four device kernels) -> ``(dr, dk, dv, dlog_w, du,
    dstate0)``: the gradients of ``wkv_chunked``'s (out, final state)
    against ``dout`` (float32 ``[B, H, S, D]``, any strides with a
    contiguous last axis) and ``dstate`` (float32 ``[B, H, D, D]``, None
    for zeros), from the forward's arguments, its ``states`` and, with a
    ``dstate``, its final ``state``.  dr, dk,
    dv come in the dtypes and, where those are dense, the layouts of r, k,
    v; dlog_w in log_w's; du ``[H, D]`` and dstate0 ``[B, H, D, D]``
    float32."""
    name = BWD
    b, h, s, d = _check(name, r, k, v, log_w, u, chunk)
    dev = r.device
    build.check_arg(name, "states", states, torch.float32,
                    (b, h, s // chunk, d, d), dev)
    if dout.shape != r.shape or dout.dtype != torch.float32 or \
            dout.device != dev:
        raise ValueError(f"{name}: dout must be a float32 {tuple(r.shape)} "
                         f"tensor on {dev}, got {dout.dtype} "
                         f"{tuple(dout.shape)} on {dout.device}")
    if dout.numel() and dout.stride(3) != 1:
        dout = dout.contiguous()
    if dstate is not None:
        for arg, t in (("dstate", dstate), ("state", state)):
            if t is None:
                raise ValueError(f"{name}: a dstate needs the forward's "
                                 f"final state")
            build.check_arg(name, arg, t, torch.float32, (b, h, d, d), dev)
    dr, dk, dv, dlog_w = (torch.empty_like(t) for t in (r, k, v, log_w))
    du = torch.empty((h, d), dtype=torch.float32, device=dev)
    dstate0 = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    if not r.numel():
        return dr, dk, dv, dlog_w, du.zero_(), dstate0.zero_() \
            if dstate is None else dstate.clone()
    if states.data_ptr() % 16:          # its rows are copied 16 bytes at
        states = states.clone()          # a time
    nc = s // chunk
    gs = torch.empty((b, h, nc, d, d), dtype=torch.float32, device=dev)
    el, gl, du_part = torch.empty((3, b, h, nc, d), dtype=torch.float32,
                                  device=dev)
    strides = (ctypes.c_longlong * 27)(*(
        x for t in (r, k, v, log_w, dout, dr, dk, dv, dlog_w)
        for x in t.stride()[:3]))
    rc = _launcher("wkv_bwd")(
        DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        log_w.data_ptr(), u.data_ptr(), states.data_ptr(), dout.data_ptr(),
        0 if dstate is None else dstate.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dlog_w.data_ptr(), gs.data_ptr(),
        el.data_ptr(), gl.data_ptr(), du_part.data_ptr(),
        0 if dstate is None else state.data_ptr(), du.data_ptr(),
        dstate0.data_ptr(), b, h, s, d, chunk,
        int(_vec(r, k, v, log_w, dout)), strides,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1
    return dr, dk, dv, dlog_w, du, dstate0
