"""The simulation engine — the port of ``repro/core/jaxsim.py``.

The reference runs a lane as a ``lax.while_loop`` of one body, and a
fleet of lanes as ``jax.vmap`` of that loop.  Here the lane axis is
written out: every ``EngState`` leaf leads with ``[L, ...]``, a body
advances all lanes at once, and ``sweep.run_while`` reproduces the
vmapped while-loop (the body runs on every lane, and the lanes whose
``cond`` was already false keep their state).  A single run is ``L = 1``.

Two step modes share the state (``engine_parts(step_mode=...)``):

* ``cohort`` (default) processes every slot whose next event falls in
  the quantum ``[t_min, t_min + cohort_dt]``.  PPCC goes through the
  fused cohort step (``ppcc.cohort_step_fused``), whose pairwise relations
  come from the cohort-step megakernel on the card, or with
  ``fused=False`` through the reference's multipass chain
  (``ppcc.cohort_step``, then ``ppcc.wc_acquire_many`` and
  ``ppcc.can_commit_many``; bit-identical, and no megastep launch); 2PL
  and OCC through their batched adapters.  FCFS resource reservation and
  the OCC validation are one scan launch each (``kernels.ops``).
* ``event`` processes exactly one event per lane and iteration: the slot
  with the earliest ``next_time`` (the first on a tie), through the
  reference's five handlers.  The reference picks one handler with
  ``lax.switch`` and nested ``lax.cond``s; here, as ``vmap`` batches
  them, every branch is computed from the same input state and the
  results merge by disjoint per-lane masks, each lane keeping the key
  its own branch split.  The body reads nothing back to the host.

The reference's single-lane cohort body gates its quiet iterations with
``lax.cond``s whose branches are exact under empty masks; on the card
each gate would be a host read, so the port runs the gate-free fleet
body for single runs too (``make_engine``, ``make_padded_engine``,
``simulate``, ``simulate_sweep``) and gets the same results.

``EngCfg.delta`` (PPCC, fused cohort mode) carries the four relations in
the state (``EngState.rel``) instead: init seeds them from one megastep
launch, and each iteration recomputes only the rows and mirrored columns
of the slots it dirtied, in one row-slab drain launch (``_delta_update``).
``EngCfg.telemetry`` (cohort mode) folds each iteration's commits,
aborts, blocks and waits into the ``obs.metrics`` accumulators
(``EngState.tm``) and, with ``trace_every > 0``, samples a per-lane ring
buffer.  Off, ``rel`` and ``tm`` are zero-size leaves and the results are
the same bit for bit.

Random numbers come from ``core.rng``, the bit-exact twin of the
reference's ``jax.random`` stream: each lane carries its own key.  A
lane started from the same seed and runtime parameters therefore
produces the same state, leaf for leaf, as the reference.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import bitset as B
from . import ppcc as P
from . import rng
from .types import SimParams, SimResult
from ..device import resolve
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels.ref import INF        # float32(1e30): an idle slot's time
from ..obs import metrics as M

HALF_INF = 5.000000075237331e29      # float32(1e30) * 0.5: "idle" test

# Op-axis draw quantum: samplers always draw bucket(max_ops, OP_QUANTUM)
# ops and slice, so the random stream does not depend on the op bucket.
OP_QUANTUM = 20

# event kinds
EV_ATTEMPT, EV_DISK_DONE, EV_FLUSH_DONE, EV_TIMEOUT, EV_RESTART = range(5)
# phases
PH_READ, PH_BLOCKED, PH_WC_LOCK, PH_WC_PREC, PH_FLUSH, PH_RESTART, PH_OFF \
    = range(7)


class RtParams(NamedTuple):
    """Workload axes that are runtime values, one entry per lane
    (``[L]`` tensors), below the engine's static buckets."""
    d: torch.Tensor           # int32 live item count (<= cfg.d)
    write_prob: torch.Tensor  # float32
    len_lo: torch.Tensor      # int32 txn length bounds (len_hi <= max_ops)
    len_hi: torch.Tensor
    cpus: torch.Tensor        # int32 live pool sizes (<= cfg.cpus/disks)
    disks: torch.Tensor
    zipf_theta: torch.Tensor  # float32 hot-spot skew (0 = uniform)


def rt_of(p: SimParams, lanes: int = 1, device=None) -> RtParams:
    """The runtime-axis values of a parameter setting, for ``lanes``
    lanes."""
    dev = resolve(device)

    def full(v, dtype):
        return torch.full((lanes,), v, dtype=dtype, device=dev)

    i32, f32 = torch.int32, torch.float32
    return RtParams(
        d=full(p.db_size, i32), write_prob=full(p.write_prob, f32),
        len_lo=full(max(2, p.txn_size_mean - p.txn_size_spread), i32),
        len_hi=full(p.txn_size_mean + p.txn_size_spread, i32),
        cpus=full(p.num_cpus, i32), disks=full(p.num_disks, i32),
        zipf_theta=full(getattr(p, "zipf_theta", 0.0), f32))


class EngState(NamedTuple):
    """Engine state of L lanes (the reference's ``EngState`` with a lane
    axis)."""
    now: torch.Tensor          # f32[L]
    key: torch.Tensor          # int32[L, 2] threefry key words
    pstate: P.PPCCState        # protocol state
    dirty: torch.Tensor        # int32[L, n, W] OCC validation bitmap
    kinds: torch.Tensor        # int8[L, n, max_ops] op kinds (-1 pad)
    items: torch.Tensor        # int32[L, n, max_ops]
    op_idx: torch.Tensor       # int32[L, n]
    phase: torch.Tensor        # int8[L, n]
    next_time: torch.Tensor    # f32[L, n]
    next_kind: torch.Tensor    # int8[L, n]
    deadline: torch.Tensor     # f32[L, n] block timeout deadline
    flush_left: torch.Tensor   # int32[L, n]
    cpu_free: torch.Tensor     # f32[L, C]
    disk_free: torch.Tensor    # f32[L, K]
    commits: torch.Tensor      # int32[L]
    aborts: torch.Tensor
    blocks: torch.Tensor
    ops_done: torch.Tensor
    iters: torch.Tensor
    pool_kinds: torch.Tensor   # int8[L, P, max_ops] pre-sampled txn pool
    pool_items: torch.Tensor   # int32[L, P, max_ops]
    pool_next: torch.Tensor    # int32[L] next pool row to hand out
    rt: RtParams               # runtime workload axes (loop-invariant)
    rel: P.Relations           # bool[L, n, n] carried relations when
                               # cfg.delta (else [L, 0, 0]); equal to
                               # compute_relations of pstate and the
                               # op cursor the next body will see
    tm: M.Telemetry            # telemetry when cfg.telemetry (else
                               # zero-size leaves)


@dataclasses.dataclass(frozen=True)
class EngCfg:
    protocol: str
    n: int                       # MPL slots (static bucket)
    d: int                       # item-bit bucket (live count is rt.d)
    max_ops: int                 # op-list capacity (static bucket)
    ops_draw: int                # sampler draw width (see OP_QUANTUM)
    cpus: int                    # resource-pool buckets (live: rt.cpus/disks)
    disks: int
    cpu_mean: float
    cpu_spread: float
    io_mean: float
    io_spread: float
    block_timeout: float
    restart_mean: float
    horizon: float
    max_iters: int
    cohort_dt: float
    step_mode: str = "cohort"    # cohort | event (one event per iteration)
    fused: bool = True           # ppcc cohort mode: the fused step; False
                                 # runs the multipass chain (same results)
    pool: int = 0                # >0: pre-sample this many transactions
                                 # per lane at init and pop on commit
    order: str = "index"         # PPCC selection priority: index | degree
    megakernel: bool = False     # route the cohort-step relations and the
                                 # two scans through kernels.ops (the CUDA
                                 # kernels on the card); False runs their
                                 # plain versions inline
    delta: bool = False          # ppcc, fused cohort mode: carry the
                                 # relations, update only the dirty rows
                                 # per iteration
    delta_k: int = 0             # slab size of the plain drain (the
                                 # reference's row-slab capacity); the
                                 # drain kernel takes every dirty slot
    telemetry: bool = False      # carry the obs.metrics accumulators
    trace_every: int = 0         # >0: sample the ring buffer this often
    trace_len: int = 256         # ring-buffer rows per lane
    device: str = "cuda"


def default_cohort_dt(p: SimParams) -> float:
    """Half a mean read cycle (CPU burst + disk access)."""
    return 0.5 * (p.cpu_burst_mean + p.io_time_mean)


def make_cfg(p: SimParams, protocol: str, max_iters: int = 400_000,
             step_mode: str = "cohort", cohort_dt: float = None,
             n_slots: int = None, pool: int = 0, fused: bool = True,
             order: str = "index", megakernel: bool = None,
             delta: bool = False, delta_k: int = 0,
             telemetry: bool = False, trace_every: int = 0,
             trace_len: int = 256, device=None) -> EngCfg:
    """The engine configuration of ``engine_parts``.  ``delta`` applies
    to PPCC in fused cohort mode only, as in the reference; ``delta_k <=
    0`` picks ``bucket(max(1, n // 4), 8)``, the reference's default
    slab.  An unknown ``step_mode``, and ``telemetry`` with
    ``step_mode="event"``, raise ``ValueError``."""
    if protocol not in ("ppcc", "2pl", "occ"):
        raise ValueError(f"unknown protocol: {protocol!r}")
    if step_mode not in ("cohort", "event"):
        raise ValueError(f"unknown step_mode: {step_mode!r}")
    if telemetry and step_mode != "cohort":
        raise ValueError("telemetry requires step_mode='cohort'")
    dev = resolve(device)
    if megakernel is None:
        megakernel = dev.type == "cuda"
    if cohort_dt is None:
        cohort_dt = default_cohort_dt(p)
    if n_slots is None:
        n_slots = p.mpl
    if n_slots < p.mpl:
        raise ValueError(f"n_slots={n_slots} < mpl={p.mpl}")
    if delta and delta_k <= 0:
        delta_k = B.bucket(max(1, n_slots // 4), 8)
    max_ops = p.txn_size_mean + p.txn_size_spread
    return EngCfg(
        protocol=protocol, n=n_slots, d=p.db_size, max_ops=max_ops,
        ops_draw=B.bucket(max_ops, OP_QUANTUM),
        cpus=p.num_cpus, disks=p.num_disks,
        cpu_mean=p.cpu_burst_mean, cpu_spread=p.cpu_burst_spread,
        io_mean=p.io_time_mean, io_spread=p.io_time_spread,
        block_timeout=p.block_timeout, restart_mean=p.restart_delay_mean,
        horizon=p.horizon, max_iters=max_iters, cohort_dt=float(cohort_dt),
        step_mode=step_mode, fused=fused, pool=pool, order=order,
        megakernel=megakernel,
        delta=delta and protocol == "ppcc" and fused and
        step_mode == "cohort", delta_k=delta_k,
        telemetry=telemetry, trace_every=trace_every, trace_len=trace_len,
        device=str(dev))


def check_rt(p: SimParams, rt: RtParams) -> None:
    """Reject runtime values that overflow their static buckets."""
    bounds = (("d", rt.d, p.db_size),
              ("len_hi", rt.len_hi, p.txn_size_mean + p.txn_size_spread),
              ("cpus", rt.cpus, p.num_cpus),
              ("disks", rt.disks, p.num_disks))
    for name, val, cap in bounds:
        hi = int(val.max())
        if hi > cap:
            raise ValueError(
                f"rt.{name}={hi} exceeds its static bucket {cap}")


def _lane(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-lane ``[L]`` vector shaped to broadcast against ``ndim``
    dims."""
    return x.view(-1, *([1] * (ndim - 1)))


# --------------------------------------------------------------------------
# workload sampling
# --------------------------------------------------------------------------

def _zipf_cdf(cfg: EngCfg, rt: RtParams) -> torch.Tensor:
    """float32[L, d] CDF over item ranks for Zipf(``rt.zipf_theta``);
    ranks past the live ``rt.d`` get zero weight."""
    dev = rt.d.device
    ranks = torch.arange(cfg.d, dtype=torch.float32, device=dev) + 1.0
    live = torch.arange(cfg.d, device=dev)[None, :] < rt.d[:, None]
    w = torch.where(live, ranks[None, :] ** (-rt.zipf_theta[:, None]), 0.0)
    return torch.cumsum(w, 1) / torch.clamp(w.sum(1, keepdim=True),
                                            min=1e-30)


def _zipf_map(cdf: torch.Tensor, raw: torch.Tensor, rt: RtParams
              ) -> torch.Tensor:
    """Remap uniform item draws ``raw`` (``[L, ...]`` in [0, rt.d))
    through the Zipf CDF; at ``zipf_theta == 0`` ``raw`` is returned as
    drawn."""
    d = _lane(rt.d, raw.dim())
    u = raw.to(torch.float32) / d.to(torch.float32)
    z = torch.searchsorted(cdf, u.reshape(raw.shape[0], -1).contiguous(),
                           right=True).reshape(raw.shape).to(raw.dtype)
    z = torch.minimum(z, d - 1)
    return torch.where(_lane(rt.zipf_theta, raw.dim()) > 0, z, raw)


def sample_txn(key: torch.Tensor, cfg: EngCfg, rt: RtParams):
    """One transaction per key: keys ``[L, S, 2]`` -> ``(kinds
    int8[L, S, max_ops], items int32[L, S, max_ops])``, -1 pads.

    Writes target a random previously-read, not-yet-written item, picked
    as the reference's ``jax.random.categorical`` picks it
    (``rng.categorical_pick``, its hashes drawn for all ops at once).
    All draws use the ``cfg.ops_draw`` width."""
    D = cfg.ops_draw
    dev = key.device
    kl, kw, ki = rng.split(key, 3).unbind(-2)
    length = rng.randint(kl, (), _lane(rt.len_lo, 2),
                         _lane(rt.len_hi, 2) + 1)                  # [L, S]
    want_w = rng.uniform(kw, (D,)) < _lane(rt.write_prob, 3)      # [L,S,D]
    k1, k2 = rng.split(rng.split(ki, D), 2).unbind(-2)           # [L,S,D,2]
    item_r_all = _zipf_map(_zipf_cdf(cfg, rt),
                           rng.randint(k2, (), 0, _lane(rt.d, 3)), rt)
    pick_m = rng.mantissas(k1, D)         # [L, S, D, D]: every op's pick

    ar = torch.arange(D, device=dev)
    shape = tuple(key.shape[:-1])
    read_items = torch.zeros(shape + (D,), dtype=torch.int32, device=dev)
    n_read = torch.zeros(shape, dtype=torch.int64, device=dev)
    written = torch.zeros(shape + (D,), dtype=torch.bool, device=dev)
    kinds, items = [], []
    for j in range(D):
        avail = (ar < n_read[..., None]) & ~written
        n_avail = avail.sum(-1)
        do_write = want_w[..., j] & (n_avail > 0)
        wpick = rng.pick_mantissa(pick_m[..., j, :],
                                  avail | (n_avail == 0)[..., None])
        item_w = read_items.gather(-1, wpick[..., None])[..., 0]
        item_r = item_r_all[..., j]
        items.append(torch.where(do_write, item_w, item_r))
        kinds.append(torch.where(j < length, do_write.to(torch.int8), -1)
                     .to(torch.int8))
        keep = do_write | (j >= length)
        appended = read_items.scatter(-1, n_read[..., None],
                                      item_r[..., None])
        read_items = torch.where(keep[..., None], read_items, appended)
        n_read = torch.where(keep, n_read, n_read + 1)
        written = written | (do_write[..., None] & (ar == wpick[..., None]))
    return (torch.stack(kinds, -1)[..., :cfg.max_ops],
            torch.stack(items, -1)[..., :cfg.max_ops].to(torch.int32))


def sample_txns(key: torch.Tensor, cfg: EngCfg, rt: RtParams, n: int):
    """``n`` transactions per lane at once: keys ``[L, 2]`` -> ``(kinds
    int8[L, n, max_ops], items int32[L, n, max_ops])``.

    Same model as ``sample_txn``, with every draw hoisted out of the
    per-op loop (the write pick is a cumsum rank of a uniform)."""
    Lw = cfg.ops_draw
    dev = key.device
    kl, kw, kp, kr = rng.split(key, 4).unbind(-2)
    length = rng.randint(kl, (n,), _lane(rt.len_lo, 2),
                         _lane(rt.len_hi, 2) + 1)                  # [L, n]
    want_w = rng.uniform(kw, (n, Lw)) < _lane(rt.write_prob, 3)
    read_cand = _zipf_map(_zipf_cdf(cfg, rt),
                          rng.randint(kr, (n, Lw), 0, _lane(rt.d, 3)), rt)
    pick_u = rng.uniform(kp, (n, Lw))

    ar = torch.arange(Lw, device=dev)
    lanes = key.shape[0]
    read_items = torch.zeros((lanes, n, Lw), dtype=torch.int32, device=dev)
    n_read = torch.zeros((lanes, n), dtype=torch.int64, device=dev)
    written = torch.zeros((lanes, n, Lw), dtype=torch.bool, device=dev)
    kinds, items = [], []
    for j in range(Lw):
        avail = (ar < n_read[..., None]) & ~written
        n_avail = avail.sum(-1, dtype=torch.int32)
        do_write = want_w[..., j] & (n_avail > 0) & (j < length)
        target = torch.floor(pick_u[..., j] * n_avail.to(torch.float32)
                             ).to(torch.int32) + 1
        wpick = (torch.cumsum(avail, -1) == target[..., None]
                 ).to(torch.int8).argmax(-1)
        item_w = read_items.gather(-1, wpick[..., None])[..., 0]
        item_r = read_cand[..., j]
        items.append(torch.where(do_write, item_w, item_r))
        kinds.append(torch.where(j < length, do_write.to(torch.int8), -1)
                     .to(torch.int8))
        is_read = ~do_write & (j < length)
        pos = torch.clamp(n_read, max=Lw - 1)[..., None]
        cur = read_items.gather(-1, pos)[..., 0]
        read_items = read_items.scatter(
            -1, pos, torch.where(is_read, item_r, cur)[..., None])
        n_read = n_read + is_read
        written = written | (do_write[..., None] & (ar == wpick[..., None]))
    return (torch.stack(kinds, -1)[..., :cfg.max_ops],
            torch.stack(items, -1)[..., :cfg.max_ops].to(torch.int32))


# --------------------------------------------------------------------------
# resource pools and protocol adapters
# --------------------------------------------------------------------------

def _reserve(cfg: EngCfg, cpu_free, disk_free, t_req, cpu_dur, io_dur,
             cpu_m, disk_m):
    """FCFS reservation of every lane's cohort: the scan kernel on the
    card (``megakernel``), else its plain version."""
    fn = kops.reserve_cohort if cfg.megakernel else kref.reserve_cohort_ref
    return fn(cpu_free, disk_free, t_req, cpu_dur, io_dur, cpu_m, disk_m)


def _try_ops_cohort(cfg: EngCfg, ps: P.PPCCState, item, is_write, ready):
    """Batched read-phase step over a cohort of pending ops (PPCC's
    multipass chain, 2PL, OCC): (state, verdict, selected,
    block-reason), as the reference's ``jaxsim._try_ops_cohort``."""
    n = ps.n
    dev = item.device
    if cfg.protocol == "ppcc":
        return P.cohort_step(ps, item, is_write, ready)
    if cfg.protocol == "2pl":
        # lock-table ops only interact when they target the same item
        # with a write involved; keep the lowest ready claimant per item
        idx = torch.arange(n, device=dev)
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        same = (item[:, :, None] == item[:, None, :]) & \
            (is_write[:, :, None] | is_write[:, None, :]) & ~eye
        lower = idx[None, :] < idx[:, None]
        sel = ready & ~(same & ready[:, None, :] & lower).any(2)
        others = ps.active[:, None, :] & ~eye
        x_held = (B.item_cols(ps.write_set, item) & others).any(2)
        s_held = (B.item_cols(ps.read_set, item) & others).any(2)
        ok = torch.where(is_write, ~x_held & ~s_held, ~x_held) & sel
        ps2 = ps._replace(
            read_set=B.or_rowwise(ps.read_set, item, ok & ~is_write),
            write_set=B.or_rowwise(ps.write_set, item, ok & is_write))
        verdict = torch.where(ok, P.PROCEED, P.BLOCK).to(torch.int32)
        reason = torch.where(sel & ~ok, P.R_LOCK, P.R_NONE).to(torch.int32)
        return ps2, verdict, sel, reason
    # occ: ops never read other slots' protocol state — all independent
    sel = ready
    ps2 = ps._replace(
        read_set=B.or_rowwise(ps.read_set, item, sel & ~is_write),
        write_set=B.or_rowwise(ps.write_set, item, sel & is_write))
    zeros = torch.zeros_like(item)
    return ps2, zeros + P.PROCEED, sel, zeros


def _wc_cohort(cfg: EngCfg, ps: P.PPCCState, dirty, wc_m):
    """Batched wait-to-commit step (PPCC's multipass chain, 2PL, OCC):
    (state, flush, wait_lock, wait_prec, abort) masks."""
    zeros = torch.zeros_like(wc_m)
    if cfg.protocol == "ppcc":
        ps2, won = P.wc_acquire_many(ps, wc_m, exact=False)
        can = P.can_commit_many(ps2)
        return (ps2, wc_m & won & can, wc_m & ~won, wc_m & won & ~can,
                zeros)
    if cfg.protocol == "2pl":
        return ps, wc_m, zeros, zeros, zeros
    fail = B.overlap_rows(ps.read_set, dirty)
    return ps, wc_m & ~fail, zeros, zeros, wc_m & fail


def _begin_txn(cfg: EngCfg, s: EngState, mpl: torch.Tensor) -> EngState:
    """Begin the first ``mpl[l]`` slots of every lane at ``now = 0``, in
    slot order, as the reference's ``init`` loop of ``_begin_txn``
    calls: slot i takes ``key, k1, k2 = split(key, 3)``, samples its
    transaction from ``k1``, draws its first CPU burst from ``k2`` and
    reserves a CPU FCFS.  The key advances only where ``i < mpl``."""
    n, dev = cfg.n, s.now.device
    key = s.key
    k1s, k2s = [], []
    for i in range(n):
        nxt, k1, k2 = rng.split(key, 3).unbind(-2)
        k1s.append(k1)
        k2s.append(k2)
        key = torch.where((i < mpl)[:, None], nxt, key)
    m = torch.arange(n, device=dev)[None, :] < mpl[:, None]      # [L, n]
    kinds, items = sample_txn(torch.stack(k1s, 1), cfg, s.rt)
    dur = rng.uniform(torch.stack(k2s, 1), (), cfg.cpu_mean - cfg.cpu_spread,
                      cfg.cpu_mean + cfg.cpu_spread)
    zero = torch.zeros_like(dur)
    cpu_free, disk_free, cpu_done, _ = _reserve(
        cfg, s.cpu_free, s.disk_free, zero, dur, zero, m,
        torch.zeros_like(m))
    return s._replace(
        key=key,
        kinds=torch.where(m[..., None], kinds, s.kinds),
        items=torch.where(m[..., None], items, s.items),
        op_idx=torch.where(m, 0, s.op_idx),
        pstate=P.begin_many(s.pstate, m),
        phase=torch.where(m, PH_READ, s.phase),
        flush_left=torch.where(m, 0, s.flush_left),
        cpu_free=cpu_free, disk_free=disk_free,
        next_time=torch.where(m, cpu_done, s.next_time),
        next_kind=torch.where(m, EV_ATTEMPT, s.next_kind))


def init(cfg: EngCfg, seed, mpl, rt: RtParams) -> EngState:
    """The engine state of L lanes: lane l runs seed ``seed[l]`` with
    ``mpl[l]`` active slots and runtime axes ``rt`` (``[L]`` leaves)."""
    dev = torch.device(cfg.device)
    seed = torch.as_tensor(seed, dtype=torch.int32, device=dev).reshape(-1)
    mpl = torch.as_tensor(mpl, dtype=torch.int32, device=dev).reshape(-1)
    lanes, n, mo = seed.shape[0], cfg.n, cfg.max_ops
    key = rng.PRNGKey(seed)
    if cfg.pool:
        key, kp = rng.split(key, 2).unbind(-2)
        pool_kinds, pool_items = sample_txns(kp, cfg, rt, cfg.pool)
    else:
        pool_kinds = torch.zeros((lanes, 0, mo), dtype=torch.int8,
                                 device=dev)
        pool_items = torch.zeros((lanes, 0, mo), dtype=torch.int32,
                                 device=dev)
    # pool entries past the live size hold free_at = INF: FCFS argmin
    # never picks them while a live server exists
    f32, i32 = torch.float32, torch.int32
    live = torch.where(torch.arange(cfg.cpus, device=dev)[None, :]
                       < rt.cpus[:, None], 0.0, INF).to(f32)
    live_d = torch.where(torch.arange(cfg.disks, device=dev)[None, :]
                         < rt.disks[:, None], 0.0, INF).to(f32)
    zl = torch.zeros(lanes, dtype=i32, device=dev)
    zn = torch.zeros((lanes, n), dtype=i32, device=dev)
    trace_len = cfg.trace_len if cfg.trace_every > 0 else 0
    s = EngState(
        now=torch.zeros(lanes, dtype=f32, device=dev), key=key,
        pstate=P.init_state(lanes, n, cfg.d, device=dev),
        dirty=B.zeros(lanes, n, cfg.d, device=dev),
        kinds=torch.full((lanes, n, mo), -1, dtype=torch.int8, device=dev),
        items=torch.zeros((lanes, n, mo), dtype=i32, device=dev),
        op_idx=zn, phase=torch.full((lanes, n), PH_OFF, dtype=torch.int8,
                                    device=dev),
        next_time=torch.full((lanes, n), INF, dtype=f32, device=dev),
        next_kind=torch.zeros((lanes, n), dtype=torch.int8, device=dev),
        deadline=torch.zeros((lanes, n), dtype=f32, device=dev),
        flush_left=zn, cpu_free=live, disk_free=live_d,
        commits=zl, aborts=zl, blocks=zl, ops_done=zl, iters=zl,
        pool_kinds=pool_kinds, pool_items=pool_items, pool_next=zl, rt=rt,
        rel=P.empty_relations(lanes, n if cfg.delta else 0, dev),
        tm=M.init_telemetry(lanes, n if cfg.telemetry else 0, trace_len,
                            dev))
    s = _begin_txn(cfg, s, mpl)
    if cfg.delta:
        # seed the carried-relations invariant at the first body's cursor
        c = _classify(cfg, s)
        ps = s.pstate
        if cfg.megakernel:
            rel = P.Relations(*kops.megastep_relations(
                ps.read_set, ps.write_set, s.dirty, c.cur_item, c.cur_w,
                ps.active, c.read_m, ps.haslocks)[:4])
        else:
            rel = P.compute_relations(ps, c.cur_item, c.cur_w)
        s = s._replace(rel=rel)
    return s


def cond(cfg: EngCfg, s: EngState) -> torch.Tensor:
    """bool[L]: the lane's while-loop goes on."""
    return (s.now <= cfg.horizon) & (s.iters < cfg.max_iters) & \
        (s.next_time.min(1).values < HALF_INF)


# --------------------------------------------------------------------------
# the cohort body
# --------------------------------------------------------------------------

class Cohort(NamedTuple):
    """The classification of one iteration's cohort, per lane and slot."""
    t0: torch.Tensor            # f32[L] quantum start
    ready: torch.Tensor         # bool[L, n] slot's event falls in the quantum
    te: torch.Tensor            # f32[L, n] per-slot event time
    n_ops: torch.Tensor         # [L, n] ops in the slot's transaction
    done_reading: torch.Tensor  # bool[L, n]
    is_disk: torch.Tensor       # bool[L, n] disk read completes
    is_fl: torch.Tensor         # bool[L, n] flush write completes
    is_rs: torch.Tensor         # bool[L, n] restart delay ends
    to_expired: torch.Tensor    # bool[L, n] block / lock wait times out
    read_m: torch.Tensor        # bool[L, n] read-phase op attempts
    wc_m: torch.Tensor          # bool[L, n] wait-to-commit attempts
    cur_item: torch.Tensor      # int32[L, n] pending op's item
    cur_w: torch.Tensor         # bool[L, n] pending op writes


def _classify(cfg: EngCfg, s: EngState) -> Cohort:
    t0 = s.next_time.min(1).values
    ready = (s.next_time <= (t0 + cfg.cohort_dt)[:, None]) & \
        (s.next_time < HALF_INF)
    te = torch.where(ready, s.next_time, t0[:, None])
    kind, phase = s.next_kind, s.phase
    n_ops = (s.kinds >= 0).sum(2)
    done_reading = s.op_idx >= n_ops
    in_wc = (phase == PH_WC_LOCK) | (phase == PH_WC_PREC)
    still_wait = (phase == PH_BLOCKED) | (phase == PH_WC_LOCK)
    is_att = ready & (kind == EV_ATTEMPT)
    is_to = ready & (kind == EV_TIMEOUT)
    expired = still_wait & (s.deadline <= te)
    att = is_att | (is_to & ~expired)
    op_i = torch.clamp(s.op_idx, max=cfg.max_ops - 1).to(torch.int64)
    return Cohort(
        t0=t0, ready=ready, te=te, n_ops=n_ops, done_reading=done_reading,
        is_disk=ready & (kind == EV_DISK_DONE),
        is_fl=ready & (kind == EV_FLUSH_DONE),
        is_rs=ready & (kind == EV_RESTART),
        to_expired=is_to & expired,
        read_m=att & ~(done_reading | in_wc),
        wc_m=att & (done_reading | in_wc),
        cur_item=s.items.gather(2, op_i[..., None])[..., 0],
        cur_w=s.kinds.gather(2, op_i[..., None])[..., 0] == 1)


def megastep_args(cfg: EngCfg, s: EngState) -> tuple:
    """The arguments the PPCC body passes to
    ``kernels.ops.megastep_relations`` for state ``s``."""
    c = _classify(cfg, s)
    ps = s.pstate
    return (ps.read_set, ps.write_set, s.dirty, c.cur_item, c.cur_w,
            ps.active, c.read_m, ps.haslocks)


def _body_consts(cfg: EngCfg):
    """(lo, hi, edges) on the engine's device: float32[3, 1] bounds of
    the body's three uniform draws — CPU burst, disk access, restart
    delay — and the telemetry's histogram edges as float32.  Made once
    per engine, so the body copies nothing from the host."""
    lo = (cfg.cpu_mean - cfg.cpu_spread, cfg.io_mean - cfg.io_spread,
          0.5 * cfg.restart_mean)
    hi = (cfg.cpu_mean + cfg.cpu_spread, cfg.io_mean + cfg.io_spread,
          1.5 * cfg.restart_mean)
    f32 = torch.float32
    return (torch.tensor(lo, dtype=f32, device=cfg.device)[:, None],
            torch.tensor(hi, dtype=f32, device=cfg.device)[:, None],
            torch.as_tensor(M.EDGES, dtype=f32, device=cfg.device))


def _delta_update(cfg: EngCfg, s: EngState, ps5: P.PPCCState, cur_item,
                  cur_w, new_kinds, new_items, op_new) -> P.Relations:
    """The carried relations for the next iteration's cursor: find the
    slots whose words or op cursor changed and recompute only their
    rows and mirrored columns, every lane in one drain launch
    (``kernels.ops.rowslab_drain``), with no host read.

    The reference drains each lane's dirty set in a ``while_loop`` of
    ``ceil(m / K)`` row slabs; later slabs' mirrored columns repair the
    stale entries between dirty slots of earlier ones, so it ends at the
    full recompute, which the drain kernel computes at once.  Its plain
    version (``megakernel`` off, or the CPU) keeps the reference's slabs
    of ``delta_k``.  The tables are new tensors: ``sweep.run_while``
    keeps a finished lane's parent state, ``s.rel`` included."""
    nxt_i = torch.clamp(op_new, max=cfg.max_ops - 1).to(torch.int64)
    nxt_item = new_items.gather(2, nxt_i[..., None])[..., 0]
    nxt_w = new_kinds.gather(2, nxt_i[..., None])[..., 0] == 1
    dirty_m = P.dirty_slots(s.pstate, ps5, cur_item, nxt_item, cur_w,
                            nxt_w)
    args = (ps5.read_set, ps5.write_set, *s.rel, nxt_item, nxt_w,
            ps5.active, dirty_m)
    if cfg.megakernel:
        return P.Relations(*kops.rowslab_drain(*args, k=cfg.delta_k))
    return P.Relations(*kref.rowslab_drain_ref(*args, k=cfg.delta_k))


def _cohort_body(cfg: EngCfg, s: EngState, consts) -> EngState:
    """One cohort iteration of every lane — the reference's
    ``jaxsim._cohort_body`` for ``fleet=True`` engines (and, its gates
    being exact, for single-lane ones).  ``consts`` is
    ``_body_consts(cfg)``."""
    n = cfg.n
    i32, i8 = torch.int32, torch.int8
    c = _classify(cfg, s)
    t0, te, phase = c.t0, c.te, s.phase
    t0c = t0[:, None]
    n_ops, done_reading = c.n_ops, c.done_reading
    is_disk, is_fl, is_rs = c.is_disk, c.is_fl, c.is_rs
    read_m, wc_m, to_expired = c.read_m, c.wc_m, c.to_expired
    cur_item, cur_w = c.cur_item, c.cur_w

    # per-iteration randomness: one threefry pass for the three uniforms
    key, kc, kd, kr, kt = rng.split(s.key, 5).unbind(-2)
    lo, hi, edges = consts
    dur_cpu, dur_io, delay = rng.uniform(
        torch.stack([kc, kd, kr], 1), (n,), lo, hi).unbind(1)

    # ---------------- read-phase + wait-to-commit cohorts --------------
    if cfg.protocol == "ppcc" and cfg.fused:
        rel = None
        if cfg.delta:
            # the carried relations already equal this iteration's full
            # recompute: only the per-quantum reductions run
            rel = P.relations_inputs(s.rel, read_m, s.pstate.haslocks)
        elif cfg.megakernel:
            ps = s.pstate
            rel = kops.megastep_relations(
                ps.read_set, ps.write_set, s.dirty, cur_item, cur_w,
                ps.active, read_m, ps.haslocks)
        fs = P.cohort_step_fused(s.pstate, cur_item, cur_w, read_m, wc_m,
                                 order=cfg.order, relations=rel)
        ps2 = fs.state
        verdict, sel, reason, degree = fs.verdict, fs.selected, fs.reason, \
            fs.degree
        flush_m = wc_m & fs.won & fs.can_commit
        wait_prec_m = wc_m & fs.won & ~fs.can_commit
        wait_lock_m = wc_m & ~fs.won
        wc_abort = torch.zeros_like(wc_m)
    else:
        ps1, verdict, sel, reason = _try_ops_cohort(cfg, s.pstate, cur_item,
                                                    cur_w, read_m)
        degree = torch.zeros_like(reason)
        ps2, flush_m, wait_lock_m, wait_prec_m, wc_abort = \
            _wc_cohort(cfg, ps1, s.dirty, wc_m)
    deferred = read_m & ~sel
    proceed = sel & (verdict == P.PROCEED)
    v_block = sel & (verdict == P.BLOCK)
    v_abort = sel & (verdict == P.ABORT)
    op2 = s.op_idx + proceed.to(i32)
    was_last = proceed & (op2 >= n_ops)
    rd_disk = proceed & ~cur_w
    wr_cpu = proceed & cur_w & ~was_last
    wr_wc = proceed & cur_w & was_last
    n_w = B.popcount(ps2.write_set)
    flush_io = flush_m & (n_w > 0)
    flush_zero = flush_m & (n_w == 0)

    # ---------------- flush completions ----------------
    left = s.flush_left - is_fl.to(i32)
    flush_more = is_fl & (left > 0)
    flush_done = is_fl & (left <= 0)

    # ---------------- commits / aborts ----------------
    commit_pre = flush_zero | flush_done
    if cfg.protocol == "occ":
        # re-validate at commit, against the dirty map and the writes of
        # the lower same-iteration committers that passed (one scan)
        fn = kops.occ_validate if cfg.megakernel else kref.occ_validate_ref
        occ_fail = fn(commit_pre, ps2.read_set, s.dirty, ps2.write_set)
    else:
        occ_fail = torch.zeros_like(commit_pre)
    commit_now = commit_pre & ~occ_fail
    abort_now = to_expired | v_abort | wc_abort | occ_fail

    # ---------------- leave + re-begin ----------------
    begin_m = commit_now | is_rs
    dirty = s.dirty
    ps = ps2
    if cfg.protocol == "occ":
        union = B.or_reduce(torch.where(commit_now[..., None], ps.write_set,
                                        0), axis=1)
        receivers = ps.active & ~commit_now & ~abort_now
        dirty = torch.where(receivers[..., None], dirty | union[:, None, :],
                            dirty)
        dirty = B.clear_rows(dirty, commit_now | abort_now)
    if cfg.protocol == "ppcc":
        ps5 = P.begin_many(P.abort_many(P.commit_many(ps, commit_now),
                                        abort_now), begin_m)
    else:
        # 2pl / occ never write prec, class bits or locks
        gone = commit_now | abort_now
        ps5 = ps._replace(
            read_set=B.clear_rows(ps.read_set, gone | begin_m),
            write_set=B.clear_rows(ps.write_set, gone | begin_m),
            active=(ps.active & ~gone) | begin_m)

    pool_next = s.pool_next
    if cfg.pool:
        # the c-th committing slot (slot order) takes pool row
        # (pool_next + c) mod P
        rank = torch.cumsum(commit_now, 1) - 1
        take = (pool_next[:, None] + torch.where(commit_now, rank, 0)) \
            % cfg.pool
        gidx = take[..., None].expand(-1, -1, cfg.max_ops)
        fresh_kinds = s.pool_kinds.gather(1, gidx)
        fresh_items = s.pool_items.gather(1, gidx)
        pool_next = ((pool_next + commit_now.sum(1)) % cfg.pool).to(i32)
    else:
        fresh_kinds, fresh_items = sample_txns(kt, cfg, s.rt, n)
    new_kinds = torch.where(commit_now[..., None], fresh_kinds, s.kinds)
    new_items = torch.where(commit_now[..., None], fresh_items, s.items)

    # ---------------- resource reservations (one scan) -----------------
    cpu_req = wr_cpu | (is_disk & ~done_reading) | begin_m
    disk_req = rd_disk | flush_more | flush_io
    cpu_free, disk_free, cpu_done, disk_done = _reserve(
        cfg, s.cpu_free, s.disk_free, te, dur_cpu.contiguous(),
        dur_io.contiguous(), cpu_req, disk_req)

    # ---------------- transitions (masks are pairwise disjoint) --------
    nt, nk = s.next_time, s.next_kind
    ph, dl, fl = s.phase, s.deadline, left

    def put(m, arr, val):
        return torch.where(m, val, arr)

    # deferred read ops: retry next iteration at their own event time
    nt = put(deferred, nt, te)
    nk = put(deferred, nk, EV_ATTEMPT)
    # read proceeded -> disk read
    nt = put(rd_disk, nt, disk_done)
    nk = put(rd_disk, nk, EV_DISK_DONE)
    ph = put(rd_disk, ph, PH_READ)
    # write proceeded, not last -> next CPU burst
    nt = put(wr_cpu, nt, cpu_done)
    nk = put(wr_cpu, nk, EV_ATTEMPT)
    ph = put(wr_cpu, ph, PH_READ)
    # last write proceeded -> enter wait-to-commit immediately
    nt = put(wr_wc, nt, te)
    nk = put(wr_wc, nk, EV_ATTEMPT)
    ph = put(wr_wc, ph, PH_READ)
    # read-phase block
    was_blocked = phase == PH_BLOCKED
    new_dl = torch.where(was_blocked, s.deadline, te + cfg.block_timeout)
    dl = put(v_block, dl, new_dl)
    ph = put(v_block, ph, PH_BLOCKED)
    nt = put(v_block, nt, new_dl)
    nk = put(v_block, nk, EV_TIMEOUT)
    # wait-to-commit routing
    ph = put(flush_m, ph, PH_FLUSH)
    fl = put(flush_m, fl, n_w)
    nt = put(flush_io, nt, disk_done)
    nk = put(flush_io, nk, EV_FLUSH_DONE)
    first_lock = phase != PH_WC_LOCK
    lock_dl = torch.where(first_lock, te + cfg.block_timeout, s.deadline)
    dl = put(wait_lock_m, dl, lock_dl)
    ph = put(wait_lock_m, ph, PH_WC_LOCK)
    nt = put(wait_lock_m, nt, lock_dl)
    nk = put(wait_lock_m, nk, EV_TIMEOUT)
    ph = put(wait_prec_m, ph, PH_WC_PREC)
    nt = put(wait_prec_m, nt, INF)
    nk = put(wait_prec_m, nk, EV_ATTEMPT)
    # disk completions
    disk_cpu = is_disk & ~done_reading
    nt = put(disk_cpu, nt, cpu_done)
    nk = put(disk_cpu, nk, EV_ATTEMPT)
    disk_wc = is_disk & done_reading
    nt = put(disk_wc, nt, te)
    nk = put(disk_wc, nk, EV_ATTEMPT)
    # flush continues
    nt = put(flush_more, nt, disk_done)
    nk = put(flush_more, nk, EV_FLUSH_DONE)
    # aborts -> restart later
    ph = put(abort_now, ph, PH_RESTART)
    nt = put(abort_now, nt, te + delay)
    nk = put(abort_now, nk, EV_RESTART)
    # begins (fresh after commit / reuse after restart delay)
    ph = put(begin_m, ph, PH_READ)
    fl = put(begin_m, fl, 0)
    nt = put(begin_m, nt, cpu_done)
    nk = put(begin_m, nk, EV_ATTEMPT)
    op_new = put(begin_m, op2, 0)

    # wake waiters on any commit/abort
    any_leave = (commit_now | abort_now).any(1, keepdim=True)
    waiting = (ph == PH_BLOCKED) | (ph == PH_WC_LOCK) | (ph == PH_WC_PREC)
    nt = torch.where(any_leave & waiting, torch.minimum(nt, t0c), nt)

    rel = s.rel
    if cfg.delta:
        rel = _delta_update(cfg, s, ps5, cur_item, cur_w, new_kinds,
                            new_items, op_new)

    new_block = v_block & ~was_blocked

    tm = s.tm
    if cfg.telemetry:
        f32 = torch.float32
        # wait episodes: open on a block / wc-lock / wc-prec entry
        # (wait_from = INF: none open), close, folding the span into
        # wait_acc, in the quantum the slot is processed out of waiting
        entering = (v_block | wait_lock_m | wait_prec_m) & \
            (tm.wait_from > HALF_INF)
        wfrom = torch.where(entering, te, tm.wait_from)
        exiting = c.ready & (wfrom < HALF_INF) & ~waiting
        wacc = torch.where(exiting, tm.wait_acc + (te - wfrom), tm.wait_acc)
        wfrom = torch.where(exiting, INF, wfrom)

        # commit folds: other slots go to a one-past-the-end bin, dropped
        def fold(hist, idx, width):
            add = torch.zeros((hist.shape[0], width + 1), dtype=i32,
                              device=hist.device)
            add.scatter_add_(1, idx.to(torch.int64),
                             torch.ones_like(idx, dtype=i32))
            return hist + add[:, :width]

        def bins(v):
            return torch.searchsorted(edges, v.contiguous(), right=True)

        lat_hist = fold(tm.lat_hist, torch.where(
            commit_now, bins(te - tm.first_start), M.NBINS), M.NBINS)
        wait_hist = fold(tm.wait_hist, torch.where(
            commit_now, bins(wacc), M.NBINS), M.NBINS)
        restart_hist = fold(tm.restart_hist, torch.where(
            commit_now, torch.clamp(tm.restarts, max=M.RBINS - 1),
            M.RBINS), M.RBINS)
        first_start = torch.where(commit_now, te, tm.first_start)
        wacc = torch.where(commit_now, 0.0, wacc)
        restarts = torch.where(commit_now, 0,
                               tm.restarts + abort_now.to(i32))

        # abort causes: a priority-masked partition, so each aborting
        # slot is charged to exactly one cause
        rest = abort_now
        cause_counts = []
        for cm in (to_expired & was_blocked, to_expired & ~was_blocked,
                   v_abort, wc_abort, occ_fail):
            cause_counts.append((rest & cm).sum(1, dtype=i32))
            rest = rest & ~cm
        abort_causes = tm.abort_causes + torch.stack(cause_counts, 1)
        block_causes = tm.block_causes + torch.stack([
            (new_block & (reason == P.R_LOCK)).sum(1, dtype=i32),
            (new_block & (reason == P.R_RULE)).sum(1, dtype=i32),
            (wait_lock_m & first_lock).sum(1, dtype=i32)], 1)

        trace = tm.trace
        if cfg.trace_every > 0:
            # each lane writes its own ring row: frozen lanes count no
            # iterations, so lanes sit at different positions
            do = (s.iters % cfg.trace_every) == 0
            pos = (s.iters // cfg.trace_every) % cfg.trace_len
            row = torch.stack([
                t0, c.ready.sum(1).to(f32), (ph == PH_BLOCKED).sum(1).to(f32),
                waiting.sum(1).to(f32),
                (s.commits + commit_now.sum(1, dtype=i32)).to(f32),
                (s.aborts + abort_now.sum(1, dtype=i32)).to(f32),
                sel.sum(1).to(f32),
                torch.where(read_m, degree, 0).sum(1).to(f32)], 1)
            at = pos.to(torch.int64)[:, None, None].expand(
                -1, 1, row.shape[1])
            old = trace.gather(1, at)
            trace = trace.scatter(1, at, torch.where(
                do[:, None, None], row[:, None, :], old))
        tm = M.Telemetry(first_start, wfrom, wacc, restarts, lat_hist,
                         wait_hist, restart_hist, abort_causes,
                         block_causes, trace)

    return s._replace(
        now=t0, iters=s.iters + 1, key=key,
        pstate=ps5, dirty=dirty, kinds=new_kinds, items=new_items,
        op_idx=op_new, phase=ph.to(i8), next_time=nt, next_kind=nk.to(i8),
        deadline=dl, flush_left=fl, cpu_free=cpu_free, disk_free=disk_free,
        commits=s.commits + commit_now.sum(1, dtype=i32),
        aborts=s.aborts + abort_now.sum(1, dtype=i32),
        blocks=s.blocks + new_block.sum(1, dtype=i32),
        ops_done=s.ops_done + proceed.sum(1, dtype=i32),
        pool_next=pool_next, rel=rel, tm=tm)


# --------------------------------------------------------------------------
# the one-event body
# --------------------------------------------------------------------------

def _event_consts(cfg: EngCfg):
    """(lo, hi): float32[6] bounds of the one-event body's six uniform
    draws — disk, CPU, restart delay (the read phase's keys), then disk,
    restart delay, CPU (the two-way split's key) — on the engine's
    device."""
    io = (cfg.io_mean - cfg.io_spread, cfg.io_mean + cfg.io_spread)
    cpu = (cfg.cpu_mean - cfg.cpu_spread, cfg.cpu_mean + cfg.cpu_spread)
    rs = (0.5 * cfg.restart_mean, 1.5 * cfg.restart_mean)
    rows = (io, cpu, rs, io, rs, cpu)
    return tuple(torch.tensor([r[k] for r in rows], dtype=torch.float32,
                              device=cfg.device) for k in (0, 1))


def _reserve_one(free, now, dur, req):
    """FCFS reservation of one server per requesting lane: the lane's
    ``argmin(free)`` (first on a tie) is busy until ``max(now, free) +
    dur``.  Returns (free', done)."""
    ln = torch.arange(free.shape[0], device=free.device)
    idx = free.argmin(1)
    at = free[ln, idx]
    done = torch.maximum(now, at) + dur
    out = free.clone()
    out[ln, idx] = torch.where(req, done, at)
    return out, done


def _try_op_one(cfg: EngCfg, ps: P.PPCCState, i, x, is_write, me):
    """One read-phase op of slot ``i[l]`` per lane: (state, verdict), as
    the reference's ``jaxsim._try_op``."""
    if cfg.protocol == "ppcc":
        return P.try_op(ps, i, x, is_write)
    if cfg.protocol == "2pl":
        others = ps.active & ~me
        x_held = (B.get_col(ps.write_set, x) & others).any(1)
        s_held = (B.get_col(ps.read_set, x) & others).any(1)
        ok = torch.where(is_write, ~x_held & ~s_held, ~x_held)
        verdict = torch.where(ok, P.PROCEED, P.BLOCK)
    else:       # occ never blocks
        ok = torch.ones_like(is_write)
        verdict = torch.full_like(x, P.PROCEED)
    return ps._replace(
        read_set=B.set_bit(ps.read_set, i, x, ok & ~is_write),
        write_set=B.set_bit(ps.write_set, i, x, ok & is_write),
    ), verdict.to(torch.int32)


def _event_body(cfg: EngCfg, s: EngState, consts) -> EngState:
    """One event of every lane — the reference's ``step_mode="event"``
    body: slot ``i = argmin(next_time)`` runs the handler of its
    ``next_kind`` (``_ev_attempt``, ``_ev_disk_done``, ``_ev_flush_done``,
    ``_ev_timeout``, ``_ev_restart`` and their helpers, jaxsim.py:373-663).

    Every branch is computed from the same input state and the results
    merge by disjoint per-lane masks, as ``vmap`` batches the reference's
    ``lax.switch`` and ``lax.cond``s.  A branch splits the key 0, 1 or 2
    times (a read op's three-way split, then an abort's two-way one); each
    lane keeps the key and the draws of the branch it took.  ``consts`` is
    ``_event_consts(cfg)``."""
    n, dev = cfg.n, s.now.device
    i8, i32 = torch.int8, torch.int32
    ln = torch.arange(s.now.shape[0], device=dev)
    slots = torch.arange(n, device=dev)

    # the event: the earliest slot, its time, its handler
    i = s.next_time.argmin(1)
    me = slots[None, :] == i[:, None]                             # [L, n]
    now = s.next_time[ln, i]
    i = i.to(i32)
    kind = s.next_kind[ln, i]
    phase_i, op_i = s.phase[ln, i], s.op_idx[ln, i]
    dl_i, fl_i = s.deadline[ln, i], s.flush_left[ln, i]
    n_ops = (s.kinds[ln, i] >= 0).sum(1)
    done_reading = op_i >= n_ops
    in_wc = (phase_i == PH_WC_LOCK) | (phase_i == PH_WC_PREC)
    still = (phase_i == PH_BLOCKED) | (phase_i == PH_WC_LOCK)
    expired = still & (now >= dl_i)
    is_to = kind == EV_TIMEOUT
    att = (kind == EV_ATTEMPT) | (is_to & ~expired)
    rd = att & ~(done_reading | in_wc)
    wc = att & (done_reading | in_wc)

    # the keys a branch can end with, and every draw a branch can make
    a1, a2, a3 = rng.split(s.key, 3).unbind(-2)     # read phase, begins
    b1, b2 = a1, a2     # the two-way split: split(key, 3)'s first two keys
    c1, c2 = rng.split(a1, 2).unbind(-2)            # a read op's abort
    lo, hi = consts
    io_a, cpu_a, rs_c, io_b, rs_b, cpu_b = rng.uniform(
        torch.stack([a2, a3, c2, b2, b2, b2], 1), (), lo, hi).unbind(1)
    fresh_kinds, fresh_items = sample_txn(a2[:, None], cfg, s.rt)

    # _ev_attempt, read phase: the protocol on the pending op
    opc = op_i.clamp(max=cfg.max_ops - 1).long()
    x = s.items[ln, i, opc]
    is_w = s.kinds[ln, i, opc] == 1
    ps0 = s.pstate
    ps_r, verdict = _try_op_one(cfg, ps0, i, x, is_w, me)
    proceed = verdict == P.PROCEED
    op2 = op_i + proceed.to(i32)
    was_last = op2 >= n_ops
    rd_go = rd & proceed
    p_disk = rd_go & ~is_w                 # read: a disk access
    p_to_wc = rd_go & is_w & was_last      # last write: wait-to-commit now
    p_cpu = rd_go & is_w & ~was_last       # write: the next CPU burst
    p_block = rd & (verdict == P.BLOCK)
    p_abort_rd = rd & (verdict == P.ABORT)

    # _ev_attempt, wait-to-commit: 0 flush, 1 wait(lock), 2 wait(prec),
    # 3 abort
    if cfg.protocol == "ppcc":
        ps_w, got = P.wc_acquire_locks(ps0, i)
        code = torch.where(~got, 1, torch.where(P.can_commit(ps_w, i), 0, 2))
    elif cfg.protocol == "2pl":
        ps_w, code = ps0, torch.zeros_like(i)
    else:
        ps_w = ps0
        code = torch.where(B.overlap_rows(ps0.read_set[ln, i],
                                          s.dirty[ln, i]), 3, 0)
    n_w = B.popcount(ps_w.write_set[ln, i])
    flush = wc & (code == 0)
    p_flush_io = flush & (n_w > 0)
    p_wait_lock = wc & (code == 1)
    p_wait_prec = wc & (code == 2)
    p_abort_wc = wc & (code == 3)

    # _ev_disk_done, _ev_flush_done, _ev_timeout's abort, _ev_restart
    is_disk = kind == EV_DISK_DONE
    p_disk_wc = is_disk & done_reading
    p_disk_cpu = is_disk & ~done_reading
    is_fl = kind == EV_FLUSH_DONE
    left = fl_i - 1
    p_flush_more = is_fl & (left > 0)
    p_abort_to = is_to & expired
    p_restart = kind == EV_RESTART

    # _commit (a flush with nothing to write, or the last flush write)
    ps_base = P.PPCCState(*(P._pick(rd, a, P._pick(wc, b, c)) for a, b, c in
                            zip(ps_r, ps_w, ps0)))
    commit_try = (flush & (n_w == 0)) | (is_fl & (left <= 0))
    if cfg.protocol == "occ":
        # Kung-Robinson: re-validate at commit
        occ_fail = commit_try & B.overlap_rows(ps_base.read_set[ln, i],
                                               s.dirty[ln, i])
    else:
        occ_fail = torch.zeros_like(commit_try)
    commit = commit_try & ~occ_fail
    abort = p_abort_rd | p_abort_wc | occ_fail | p_abort_to
    begin = commit | p_restart
    leave = commit | abort

    # protocol state: leave (commit or abort), then begin
    ps = P.begin_many(P._leave_many(ps_base, me & leave[:, None]),
                      me & begin[:, None])
    dirty = s.dirty
    if cfg.protocol == "occ":
        # a commit's writes dirty every other active transaction
        recv = ps_base.active & ~me & commit[:, None]
        dirty = torch.where(recv[..., None],
                            dirty | ps_base.write_set[ln, i][:, None, :],
                            dirty)
        dirty = B.clear_rows(dirty, me & leave[:, None])
    else:
        dirty = B.clear_rows(dirty, me & abort[:, None])

    # resource pools: a lane reserves at most one server
    cpu_free, cpu_done = _reserve_one(
        s.cpu_free, now, torch.where(p_disk_cpu, cpu_b, cpu_a),
        p_cpu | p_disk_cpu | begin)
    disk_free, disk_done = _reserve_one(
        s.disk_free, now, torch.where(p_disk, io_a, io_b),
        p_disk | p_flush_io | p_flush_more)

    # slot i's next event, phase and bookkeeping, by branch
    new_dl = torch.where(phase_i == PH_BLOCKED, dl_i,
                         now + cfg.block_timeout)
    lock_dl = torch.where(phase_i != PH_WC_LOCK, now + cfg.block_timeout,
                          dl_i)
    delay = torch.where(p_abort_rd, rs_c, rs_b)

    def by(cases, default):
        out = default
        for m, v in cases:
            out = torch.where(m, v, out)
        return out

    inf = torch.full_like(now, INF)
    nt_i = by([(p_disk | p_flush_io | p_flush_more, disk_done),
               (p_to_wc | p_disk_wc, now),
               (p_cpu | p_disk_cpu | begin, cpu_done),
               (p_block, new_dl), (p_wait_lock, lock_dl),
               (abort, now + delay)], inf)
    nk_i = by([(p_disk, EV_DISK_DONE),
               (p_to_wc | p_cpu | p_wait_prec | is_disk | begin,
                EV_ATTEMPT),
               (p_block | p_wait_lock, EV_TIMEOUT),
               (p_flush_io | p_flush_more, EV_FLUSH_DONE),
               (abort, EV_RESTART)], kind.to(i32))
    ph_i = by([(rd_go, PH_READ), (p_block, PH_BLOCKED),
               (flush, PH_FLUSH), (p_wait_lock, PH_WC_LOCK),
               (p_wait_prec, PH_WC_PREC), (abort, PH_RESTART),
               (begin, PH_READ)], phase_i.to(i32))
    dl_new = by([(p_block, new_dl), (p_wait_lock, lock_dl)], dl_i)
    fl_new = by([(flush, n_w), (is_fl, left), (begin, 0)], fl_i)
    op_new = by([(rd, op2), (begin, 0)], op_i)

    # _wake_waiters on a commit or an abort: every other waiting slot's
    # next event is now
    waiting = (s.phase == PH_BLOCKED) | (s.phase == PH_WC_LOCK) | \
        (s.phase == PH_WC_PREC)
    nt = torch.where(leave[:, None] & waiting & ~me, now[:, None],
                     s.next_time)

    def put(arr, val):
        return torch.where(me, val[:, None].to(arr.dtype), arr)

    # each lane keeps the key of its branch
    key = by([(((rd & ~p_abort_rd) | begin)[:, None], a1),
              (p_abort_rd[:, None], c1),
              ((p_flush_io | p_abort_wc | is_disk | p_flush_more | occ_fail
                | p_abort_to)[:, None], b1)], s.key)
    fresh = (me & commit[:, None])[..., None]
    return s._replace(
        now=now, iters=s.iters + 1, key=key, pstate=ps, dirty=dirty,
        kinds=torch.where(fresh, fresh_kinds, s.kinds),
        items=torch.where(fresh, fresh_items, s.items),
        op_idx=put(s.op_idx, op_new), phase=put(s.phase, ph_i),
        next_time=put(nt, nt_i), next_kind=put(s.next_kind, nk_i),
        deadline=put(s.deadline, dl_new),
        flush_left=put(s.flush_left, fl_new),
        cpu_free=cpu_free, disk_free=disk_free,
        commits=s.commits + commit.to(i32),
        aborts=s.aborts + abort.to(i32),
        blocks=s.blocks + (p_block & (phase_i != PH_BLOCKED)).to(i32),
        ops_done=s.ops_done + rd_go.to(i32))


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def engine_parts(p: SimParams, protocol: str, max_iters: int = 400_000,
                 step_mode: str = "cohort", cohort_dt: float = None,
                 n_slots: int = None, pool: int = 0, fused: bool = True,
                 order: str = "index", megakernel: bool = None,
                 delta: bool = False, delta_k: int = 0,
                 telemetry: bool = False, trace_every: int = 0,
                 trace_len: int = 256, device=None):
    """``(init, cond, step)`` of an engine for ``protocol``.

    ``init(seed, mpl, rt)`` takes per-lane ``[L]`` seeds, MPLs and
    runtime axes (``rt=None``: ``p``'s own values for every lane);
    ``cond(s)`` is the per-lane loop condition and ``step(s)`` one body
    over all lanes: a cohort iteration, or one event per lane with
    ``step_mode="event"``.  ``megakernel=None`` runs the CUDA kernels on
    the card and their plain versions on the CPU.  ``fused``, ``order``,
    ``delta``, ``delta_k``, ``telemetry``, ``trace_every`` and
    ``trace_len`` are the reference's options of the same names (``order``
    applies to the fused step only).  The default ``device`` is the card;
    ``device="cpu"`` runs on the CPU."""
    cfg = make_cfg(p, protocol, max_iters=max_iters, step_mode=step_mode,
                   cohort_dt=cohort_dt, n_slots=n_slots, pool=pool,
                   fused=fused, order=order, megakernel=megakernel,
                   delta=delta, delta_k=delta_k, telemetry=telemetry,
                   trace_every=trace_every, trace_len=trace_len,
                   device=device)
    if step_mode == "event":
        consts, body = _event_consts(cfg), _event_body
    else:
        consts, body = _body_consts(cfg), _cohort_body

    def init_fn(seed, mpl=None, rt: RtParams = None) -> EngState:
        seed = torch.as_tensor(seed).reshape(-1)
        if mpl is None:
            mpl = torch.full_like(seed, p.mpl)
        if rt is None:
            rt = rt_of(p, seed.shape[0], cfg.device)
        else:
            check_rt(p, rt)
        return init(cfg, seed, mpl, rt)

    def cond_fn(s: EngState) -> torch.Tensor:
        return cond(cfg, s)

    def step_fn(s: EngState) -> EngState:
        return body(cfg, s, consts)

    init_fn.cfg = cond_fn.cfg = step_fn.cfg = cfg
    return init_fn, cond_fn, step_fn


def _run(init_fn, cond_fn, step_fn, seed, mpl=None, rt=None) -> EngState:
    from .sweep import run_while         # sweep builds on this module
    return run_while(cond_fn, step_fn, init_fn(seed, mpl, rt))[0]


def make_engine(p: SimParams, protocol: str, max_iters: int = 400_000,
                step_mode: str = "cohort", cohort_dt: float = None,
                device=None):
    """``run(seed)``: one run of ``p`` to its horizon, ``seed`` an int.
    The ``EngState`` it returns has a lane axis of 1 (``s.commits[0]``
    is the run's commit count); a vector of seeds runs one lane each."""
    parts = engine_parts(p, protocol, max_iters=max_iters,
                         step_mode=step_mode, cohort_dt=cohort_dt,
                         device=device)

    def run(seed) -> EngState:
        return _run(*parts, seed)

    run.cfg = parts[0].cfg
    return run


def make_padded_engine(p: SimParams, protocol: str, n_slots: int,
                       max_iters: int = 400_000, step_mode: str = "cohort",
                       cohort_dt: float = None, pool: int = 0,
                       fused: bool = True, order: str = "index",
                       delta: bool = False, delta_k: int = 0,
                       telemetry: bool = False, trace_every: int = 0,
                       trace_len: int = 256, device=None):
    """An engine whose MPL is a runtime value: the slot axis pads to
    ``n_slots`` and ``run(seed, mpl, rt=None)`` activates only the first
    ``mpl`` slots of each lane (``seed`` and ``mpl`` ints or ``[L]``
    vectors; ``rt`` overrides the runtime workload axes, checked against
    ``p``'s buckets).  An ``mpl`` above ``n_slots`` raises ``ValueError``.
    The returned state keeps its lane axis."""
    parts = engine_parts(p, protocol, max_iters=max_iters,
                         step_mode=step_mode, cohort_dt=cohort_dt,
                         n_slots=n_slots, pool=pool, fused=fused,
                         order=order, delta=delta, delta_k=delta_k,
                         telemetry=telemetry, trace_every=trace_every,
                         trace_len=trace_len, device=device)

    def run(seed, mpl, rt: RtParams = None) -> EngState:
        hi = int(torch.as_tensor(mpl).max())
        if hi > n_slots:
            raise ValueError(f"mpl={hi} > n_slots={n_slots}")
        seed = torch.as_tensor(seed).reshape(-1)
        mpl = torch.as_tensor(mpl).reshape(-1).expand(seed.shape[0])
        return _run(*parts, seed, mpl, rt)

    run.cfg = parts[0].cfg
    return run


def simulate(p: SimParams, protocol: str, step_mode: str = "cohort",
             device=None) -> SimResult:
    """One run of ``p`` from ``p.seed``: the reference's ``SimResult``
    (commits, aborts, blocks, ops executed, simulated time)."""
    s = make_engine(p, protocol, step_mode=step_mode, device=device)(p.seed)
    res = SimResult(protocol=protocol, params=p)
    res.commits = int(s.commits[0])
    res.aborts = int(s.aborts[0])
    res.blocks = int(s.blocks[0])
    res.ops_executed = int(s.ops_done[0])
    res.sim_time = float(min(float(s.now[0]), p.horizon))
    return res


def simulate_sweep(p: SimParams, protocol: str, seeds,
                   step_mode: str = "cohort", device=None) -> dict:
    """One lane per seed, all in one batch: ``{"commits", "aborts",
    "blocks"}`` as the reference returns them, plus ``ops_done``,
    ``iters`` and ``now``, each a numpy array over the seeds."""
    s = make_engine(p, protocol, step_mode=step_mode, device=device)(
        torch.as_tensor(seeds, dtype=torch.int32))
    return {k: getattr(s, k).cpu().numpy()
            for k in ("commits", "aborts", "blocks", "ops_done", "iters",
                      "now")}


# --------------------------------------------------------------------------
# state conversion to and from the reference's numpy view
# --------------------------------------------------------------------------

_WORDS = {"key", "dirty"}     # uint32 in the reference (and the set rows)


def state_from_numpy(tree, device=None) -> EngState:
    """The port's ``EngState`` from a reference ``EngState`` whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, s)``): a single lane
    gains a lane axis of 1 and ``uint32`` words are viewed as
    ``int32``."""
    dev = resolve(device)
    single = np.ndim(tree.now) == 0

    def conv(name, x):
        a = np.array(x)
        if name in _WORDS:
            a = a.view(np.int32)
        if single:
            a = a[None]
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    nested = {"rt": RtParams, "rel": P.Relations, "tm": M.Telemetry}
    fields = {}
    for name in EngState._fields:
        val = getattr(tree, name)
        if name == "pstate":
            fields[name] = P.state_from_numpy(val, dev)
        elif name in nested:
            cls = nested[name]
            fields[name] = cls(*(conv(f, getattr(val, f))
                                 for f in cls._fields))
        else:
            fields[name] = conv(name, val)
    return EngState(**fields)


def state_to_numpy(s: EngState) -> EngState:
    """The port's ``EngState`` with numpy leaves in the reference's
    dtypes (``int32`` words viewed back as ``uint32``); the lane axis
    stays."""
    def conv(name, x):
        a = x.detach().cpu().numpy()
        return a.view(np.uint32) if name in _WORDS else a

    fields = {}
    for name in EngState._fields:
        val = getattr(s, name)
        if name == "pstate":
            fields[name] = P.state_to_numpy(val)
        elif name in ("rt", "rel", "tm"):
            fields[name] = type(val)(*(conv(f, getattr(val, f))
                                       for f in val._fields))
        else:
            fields[name] = conv(name, val)
    return EngState(**fields)
