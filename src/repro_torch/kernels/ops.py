"""Dispatchers the engine, the scheduler and the language model call for
their kernels.

A CUDA tensor goes to the hand-written kernel (``kernels.megastep`` for
the megastep, row-slab drain and row-slab kernels, ``kernels.scan``,
``kernels.conflict``, ``kernels.admit``, ``kernels.admit_ops``,
``kernels.flash_attention``, ``kernels.wkv``), a CPU tensor to the
kernel's plain version (``kernels.ref``).  There is no fallback: a failed
build or launch on the card raises.  ``launch_counts`` reads the
wrappers' launch counters and ``reset_launches`` sets them to 0.

Under autograd (grad enabled and an input that requires it)
``flash_attention`` and ``wkv_chunked`` are ``torch.autograd.Function``s
(``_Flash``, ``_WKV``): the forward and the backward of each go to its
two kernels on CUDA tensors and to the plain versions
(``flash_attention_ref`` and ``flash_attention_bwd_ref``,
``wkv_chunked_ref`` and ``wkv_chunked_bwd_ref``) on CPU tensors.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from . import admit as _admit
from . import admit_ops as _admit_ops
from . import conflict as _conflict
from . import flash_attention as _flash
from . import megastep as _megastep
from . import ref
from . import scan as _scan
from . import wkv as _wkv


def _route(t, name: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version.  A
    DTensor raises: the kernels take raw pointers to plain tensors, and
    a sharded model computes on its parameters' local shards
    (``sharding.local_shards``) before they reach here."""
    if isinstance(t, DTensor):
        raise TypeError(f"{name}: given a DTensor; pass its local or "
                        f"gathered tensor")
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def megastep_relations(read_bits, write_bits, dirty_bits, item, is_write,
                       active, ready, haslocks):
    """Cohort-step megakernel: ``(dep, ww, writers_at, readers_at, deg,
    lockhit, dirty_hit)`` for every lane in one launch."""
    fn = _megastep.megastep if _route(read_bits, "megastep_relations") \
        else ref.megastep_ref
    return fn(read_bits, write_bits, dirty_bits, item, is_write, active,
              ready, haslocks)


def rowslab_relations(read_bits, write_bits, writers_at, readers_at, item,
                      is_write, active, slab, valid):
    """Row-slab kernel: ``(dep_rows, ww_rows, wat_rows, rat_rows)`` of
    the K slab slots of every lane in one launch."""
    fn = _megastep.rowslab if _route(read_bits, "rowslab_relations") \
        else ref.rowslab_ref
    return fn(read_bits, write_bits, writers_at, readers_at, item,
              is_write, active, slab, valid)


def rowslab_drain(read_bits, write_bits, dep, ww, writers_at, readers_at,
                  item, is_write, active, dirty, *, k: int = 0):
    """The delta drain: the next iteration's ``(dep, ww, writers_at,
    readers_at)`` of every lane, with the rows and mirrored columns of
    its ``dirty`` slots recomputed, in one launch.  ``k`` is the plain
    version's slab size (the reference's ``delta_k``); the kernel takes
    every dirty slot at once."""
    if _route(read_bits, "rowslab_drain"):
        return _megastep.rowslab_drain(read_bits, write_bits, dep, ww,
                                       writers_at, readers_at, item,
                                       is_write, active, dirty)
    return ref.rowslab_drain_ref(read_bits, write_bits, dep, ww, writers_at,
                                 readers_at, item, is_write, active, dirty,
                                 k=k)


def reserve_cohort(cpu_free, disk_free, t_req, cpu_dur, io_dur, cpu_m,
                   disk_m):
    """FCFS reservation scan: ``(cpu_free', disk_free', cpu_done,
    disk_done)``."""
    fn = _scan.reserve_cohort if _route(cpu_free, "reserve_cohort") \
        else ref.reserve_cohort_ref
    return fn(cpu_free, disk_free, t_req, cpu_dur, io_dur, cpu_m, disk_m)


def occ_validate(commit_pre, read_bits, dirty_bits, write_bits):
    """OCC same-iteration validation scan: ``bool[L, n]`` failures."""
    fn = _scan.occ_validate if _route(read_bits, "occ_validate") \
        else ref.occ_validate_ref
    return fn(commit_pre, read_bits, dirty_bits, write_bits)


def conflict_matrix(read_bits, write_bits):
    """Scheduler conflict relation: ``raw bool[N, N]``."""
    fn = _conflict.conflict_matrix if _route(read_bits, "conflict_matrix") \
        else ref.conflict_matrix_ref
    return fn(read_bits, write_bits)


def conflict_fused(read_bits, write_bits):
    """``(raw, ww, raw_deg, ww_deg)`` in one call (counted as one launch;
    the card picks the gather or the dense route)."""
    fn = _conflict.conflict_fused if _route(read_bits, "conflict_fused") \
        else ref.conflict_fused_ref
    return fn(read_bits, write_bits)


def conflict_fused_full(read_bits, write_bits):
    """``(raw, ww, raw_deg, war_deg, ww_deg, diag_raw, diag_ww)`` in one
    call (counted as one launch)."""
    fn = _conflict.conflict_fused_full \
        if _route(read_bits, "conflict_fused_full") \
        else ref.conflict_fused_full_ref
    return fn(read_bits, write_bits)


def ppcc_admit(raw, valid, seq):
    """PPCC admission scan: ``(admitted, preceding, preceded, prec)``."""
    fn = _admit.ppcc_admit if _route(raw, "ppcc_admit") \
        else ref.ppcc_admit_ref
    return fn(raw, valid, seq)


def twopl_admit(raw, ww, valid):
    """2PL admission scan: ``admitted bool[n]``."""
    fn = _admit.twopl_admit if _route(raw, "twopl_admit") \
        else ref.twopl_admit_ref
    return fn(raw, ww, valid)


def occ_admit(raw, ww, valid):
    """OCC validation scan: ``survivors bool[n]``."""
    fn = _admit.occ_admit if _route(raw, "occ_admit") \
        else ref.occ_admit_ref
    return fn(raw, ww, valid)


def admit_ops(read_set, write_set, prec, preceding, preceded, active,
              haslocks, txn, item, is_write, valid):
    """PPCC op-list admission of every lane: ``(admitted, blocked,
    aborted, *state)`` (``core.ppcc.PPCCState``'s seven leaves)."""
    fn = _admit_ops.admit_ops if _route(read_set, "admit_ops") \
        else ref.admit_ops_ref
    return fn(read_set, write_set, prec, preceding, preceded, active,
              haslocks, txn, item, is_write, valid)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


class _Flash(torch.autograd.Function):
    """Flash attention with its backward: the forward keeps q, k, v, the
    output and the row logsumexp for the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale):
        kw = dict(causal=causal, window=window, sm_scale=sm_scale)
        fn = _flash.flash_attention if _route(q, "flash_attention") \
            else ref.flash_attention_ref
        out, lse = fn(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        fn = _flash.flash_attention_bwd if _route(q, "flash_attention") \
            else ref.flash_attention_bwd_ref
        dq, dk, dv = fn(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sm_scale: float = None):
    """Flash attention: q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Sk, D]`` ->
    ``[B, Hq, Sq, D]`` in q's dtype; differentiable (``_Flash``) where an
    input requires grad."""
    if _needs_grad(q, k, v):
        return _Flash.apply(q, k, v, causal, window, sm_scale)
    fn = _flash.flash_attention if _route(q, "flash_attention") \
        else ref.flash_attention_ref
    return fn(q, k, v, causal=causal, window=window, sm_scale=sm_scale)


class _WKV(torch.autograd.Function):
    """The chunked WKV with its backward: the forward keeps its inputs, the
    state entering each chunk and the final state (which the backward
    kernel reads only with the final state's gradient); a gradient of the
    output or of the final state that autograd does not give counts as
    zero."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, state0, chunk):
        fn = _wkv.wkv_chunked if _route(r, "wkv_chunked") \
            else ref.wkv_chunked_ref
        out, state, states = fn(r, k, v, log_w, u, chunk=chunk,
                                state0=state0, return_states=True)
        ctx.save_for_backward(r, k, v, log_w, u, states, state)
        ctx.chunk = chunk
        ctx.has_state0 = state0 is not None
        ctx.set_materialize_grads(False)
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, log_w, u, states, state = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        if _route(r, "wkv_chunked"):
            grads = _wkv.wkv_chunked_bwd(r, k, v, log_w, u, states, dout,
                                         dstate, state, chunk=ctx.chunk)
        else:
            grads = ref.wkv_chunked_bwd_ref(r, k, v, log_w, u, states, dout,
                                            dstate, chunk=ctx.chunk)
        dr, dk, dv, dw, du, ds0 = grads
        return dr, dk, dv, dw, du, ds0 if ctx.has_state0 else None, None


def wkv_chunked(r, k, v, log_w, u, *, chunk: int = 64, state0=None):
    """Chunked WKV: r/k/v/log_w ``[B, H, S, D]``, u ``[H, D]`` -> (out
    float32 ``[B, H, S, D]``, final state float32 ``[B, H, D, D]``);
    differentiable (``_WKV``) where an input requires grad."""
    if _needs_grad(r, k, v, log_w, u, state0):
        return _WKV.apply(r, k, v, log_w, u, state0, chunk)
    fn = _wkv.wkv_chunked if _route(r, "wkv_chunked") \
        else ref.wkv_chunked_ref
    return fn(r, k, v, log_w, u, chunk=chunk, state0=state0)


_COUNTERS = (_megastep.launches, _scan.launches, _conflict.launches,
             _admit.launches, _admit_ops.launches, _flash.launches,
             _wkv.launches)


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launches``."""
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


def reset_launches() -> None:
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0
