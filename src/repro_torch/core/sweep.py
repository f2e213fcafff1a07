"""Padded-lane fleet sweeps — the port of ``repro/core/sweep.py``.

The paper's deliverable is the throughput-vs-MPL grid of Figs. 5–16 for
PPCC, 2PL and OCC.  As in the reference, the slot axis pads to a static
bucket (``slot_bucket``), MPL and every workload axis are per-lane
runtime values, and each protocol runs all its lanes as one batch, so
``run_grid`` runs every figure's (MPL × seed) lanes together.

The reference runs a protocol's lanes as ``jax.vmap`` over one
``lax.while_loop`` per lane.  ``run_while`` reproduces that on an
explicit lane axis: ``cond`` is computed per lane, the body runs on all
lanes, and lanes whose ``cond`` was false keep their state.  The host
reads "any lane still running" once every ``CHECK_EVERY`` iterations;
frozen lanes stay frozen, so the extra iterations change nothing.
Lane sharding over a device mesh is not ported: the fleet runs on one
card.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import bitset as B
from . import engine as E
from .types import (GRID_FIGS, SimParams, grid_cover_params,
                    paper_figure_params)
from ..device import resolve

PROTOCOLS = ("ppcc", "2pl", "occ")
METRICS = ("commits", "aborts", "blocks", "ops_done", "iters")
TELEMETRY = ("lat_hist", "wait_hist", "restart_hist", "abort_causes",
             "block_causes", "trace")
CHECK_EVERY = 32     # body iterations between host reads of "any lane on"


def slot_bucket(max_mpl: int, quantum: int = 32) -> int:
    """Pad the slot axis to a multiple of ``quantum``."""
    return B.bucket(max_mpl, quantum)


def _select(live: torch.Tensor, new, old):
    """Leaf-wise ``where(live, new, old)`` over an ``EngState`` (lane
    axis first); leaves the body returned untouched are kept as they
    are."""
    if new is old:
        return old
    if isinstance(old, tuple):
        return type(old)(*(_select(live, a, b) for a, b in zip(new, old)))
    return torch.where(live.view(-1, *([1] * (old.dim() - 1))), new, old)


def run_while(cond, step, s: E.EngState) -> Tuple[E.EngState, int]:
    """``vmap(while_loop(cond, step))`` over the lane axis.  Returns the
    final state and the number of body iterations run on the batch."""
    iters = 0
    while bool(cond(s).any()):
        for _ in range(CHECK_EVERY):
            live = cond(s)
            s = _select(live, step(s), s)
            iters += 1
    return s, iters


class Fleet:
    """One lane batch per protocol for a (protocol × lane) grid.

    ``run_lanes(seeds, mpls, rts)`` runs flat lane vectors with per-lane
    ``engine.RtParams``, so lanes of different paper figures share a
    batch as long as their values fit ``p``'s static buckets;
    ``fleet(mpls, seeds)`` runs the (MPL × seed) grid of ``p`` itself.
    After a run, ``final[proto]`` holds the final ``EngState`` of every
    lane and ``body_iters[proto]`` counts the body iterations run on the
    protocol's batch since construction.

    ``fused=False`` runs the PPCC lanes through the multipass cohort
    chain instead of the fused step (no megastep launch); ``delta=True``
    carries the PPCC relations and updates only the dirty rows per
    iteration (fused only); ``telemetry=True`` adds each protocol's
    per-lane ``telemetry`` block (``TELEMETRY``) to the results.  All
    three leave every metric unchanged.
    """

    def __init__(self, p: SimParams, protocols: Sequence[str] = PROTOCOLS,
                 n_slots: Optional[int] = None, max_iters: int = 400_000,
                 cohort_dt: Optional[float] = None,
                 pool: Optional[int] = None, fused: bool = True,
                 order: str = "index",
                 megakernel: Optional[bool] = None, delta: bool = False,
                 delta_k: int = 0, telemetry: bool = False,
                 trace_every: int = 0, trace_len: int = 256, device=None):
        if n_slots is None:
            n_slots = slot_bucket(p.mpl)
        if pool is None:
            # per-lane commits stay well under horizon/6 across the paper
            # grid; a wrapped pool would replay early-run workload
            pool = max(4096, int(p.horizon) // 6)
        self.params = p
        self.protocols = tuple(protocols)
        self.n_slots = n_slots
        self.device = resolve(device)
        self.telemetry = telemetry
        self.parts = {
            proto: E.engine_parts(p, proto, max_iters=max_iters,
                                  cohort_dt=cohort_dt, n_slots=n_slots,
                                  pool=pool, fused=fused, order=order,
                                  megakernel=megakernel, delta=delta,
                                  delta_k=delta_k, telemetry=telemetry,
                                  trace_every=trace_every,
                                  trace_len=trace_len, device=self.device)
            for proto in self.protocols}
        self.body_iters = {proto: 0 for proto in self.protocols}
        self.final: Dict[str, E.EngState] = {}

    def run_lanes(self, seeds, mpls, rts: E.RtParams
                  ) -> Dict[str, Dict[str, np.ndarray]]:
        """Run flat lane vectors: ``{protocol: {metric: array[L]}}``
        (``METRICS``, ``now`` and, with telemetry, ``telemetry``: ``{leaf:
        array[L, ...]}``)."""
        seeds = torch.as_tensor(seeds, dtype=torch.int32,
                                device=self.device).reshape(-1)
        mpls = torch.as_tensor(mpls, dtype=torch.int32,
                               device=self.device).reshape(-1)
        if int(mpls.max()) > self.n_slots:
            raise ValueError(f"max(mpls)={int(mpls.max())} exceeds "
                             f"n_slots={self.n_slots}")
        out = {}
        for proto in self.protocols:
            init, cond, step = self.parts[proto]
            s, iters = run_while(cond, step, init(seeds, mpls, rts))
            self.final[proto] = s
            self.body_iters[proto] += iters
            res = {k: getattr(s, k).cpu().numpy() for k in METRICS}
            res["now"] = s.now.cpu().numpy()
            if self.telemetry:
                res["telemetry"] = {k: getattr(s.tm, k).cpu().numpy()
                                    for k in TELEMETRY}
            out[proto] = res
        return out

    def __call__(self, mpls, seeds):
        mpls = np.asarray(mpls, np.int32)
        seeds = np.asarray(seeds, np.int32)
        m, s = mpls.shape[0], seeds.shape[0]
        rts = E.rt_of(self.params, m * s, self.device)
        flat = self.run_lanes(np.tile(seeds, m), np.repeat(mpls, s), rts)
        return {proto: _fold(res, lambda v: v.reshape((m, s) + v.shape[1:]))
                for proto, res in flat.items()}


def _fold(res, fn):
    """Apply ``fn`` to every array of a result dict, telemetry block
    included (its arrays keep their trailing axes)."""
    return {k: _fold(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in res.items()}


def run_fleet(fig: int, mpl_grid: Sequence[int], seeds: Sequence[int],
              horizon: float, protocols: Sequence[str] = PROTOCOLS,
              n_slots: Optional[int] = None, max_iters: int = 400_000,
              delta: bool = False, delta_k: int = 0,
              telemetry: bool = False, trace_every: int = 0,
              trace_len: int = 256, device=None
              ) -> Tuple[Dict[str, Dict[str, np.ndarray]], Fleet]:
    """One paper figure's (MPL × seed) grid: ``({protocol: {metric:
    np.ndarray[M, S]}}, fleet)``."""
    p = paper_figure_params(fig).with_(horizon=horizon)
    if n_slots is None:
        n_slots = slot_bucket(max(mpl_grid))
    fleet = Fleet(p, protocols=protocols, n_slots=n_slots,
                  max_iters=max_iters, delta=delta, delta_k=delta_k,
                  telemetry=telemetry, trace_every=trace_every,
                  trace_len=trace_len, device=device)
    return fleet(list(mpl_grid), list(seeds)), fleet


def grid_lanes(figs: Sequence[int], mpl_grid: Sequence[int],
               seeds: Sequence[int], device=None):
    """Flat ``(seed, mpl, rt)`` lane vectors for a figure × MPL × seed
    grid, figure-major: lane ``f*M*S + m*S + s`` is figure ``figs[f]``
    at ``mpl_grid[m]`` and ``seeds[s]``."""
    dev = resolve(device)
    m, s = len(mpl_grid), len(seeds)
    rts = [E.rt_of(paper_figure_params(f), m * s, dev) for f in figs]
    rt_l = E.RtParams(*(torch.cat(xs) for xs in zip(*rts)))
    mpl_l = torch.tensor(mpl_grid, dtype=torch.int32, device=dev
                         ).repeat_interleave(s).repeat(len(figs))
    seed_l = torch.tensor(seeds, dtype=torch.int32, device=dev
                          ).repeat(len(figs) * m)
    return seed_l, mpl_l, rt_l


def lanes_sha256(seeds, mpls, rt) -> str:
    """sha256 of flat lane vectors (``grid_lanes``' output, tensors or
    arrays): seeds, MPLs, then each ``RtParams`` leaf, as little-endian
    bytes of their dtypes.  Two packages that build the same lanes give
    the same digest."""
    h = hashlib.sha256()
    for a in (seeds, mpls, *rt):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(np.ascontiguousarray(a, a.dtype.newbyteorder("<")).tobytes())
    return h.hexdigest()


def run_grid(figs: Sequence[int] = GRID_FIGS,
             mpl_grid: Sequence[int] = (5, 10, 25, 50, 75, 100, 150),
             seeds: Sequence[int] = (0, 1), horizon: float = 20_000.0,
             protocols: Sequence[str] = PROTOCOLS,
             n_slots: Optional[int] = None, max_iters: int = 400_000,
             fleet: Optional[Fleet] = None, megakernel: Optional[bool] = None,
             fused: bool = True, delta: bool = False, delta_k: int = 0,
             telemetry: bool = False,
             trace_every: int = 0, trace_len: int = 256, device=None
             ) -> Tuple[Dict[int, Dict[str, Dict[str, np.ndarray]]], Fleet]:
    """Every paper figure's grid in one lane batch per protocol.

    The fleet's static buckets cover all the figures
    (``grid_cover_params``: 500-item words, 20-op lists, 16/32 resource
    pools) and each figure's lanes carry its live values.  Returns
    ``({fig: {protocol: {metric: np.ndarray[M, S]}}}, fleet)``, with a
    ``telemetry`` block of ``[M, S, ...]`` arrays per protocol when
    ``telemetry`` is on.  ``fused=False`` runs PPCC through the
    multipass chain.  Pass ``fleet`` from an earlier call to reuse it.
    """
    figs = tuple(figs)
    if fleet is None:
        cover = grid_cover_params(figs).with_(horizon=horizon)
        if n_slots is None:
            n_slots = slot_bucket(max(mpl_grid))
        fleet = Fleet(cover, protocols=protocols, n_slots=n_slots,
                      max_iters=max_iters, megakernel=megakernel,
                      fused=fused, delta=delta, delta_k=delta_k,
                      telemetry=telemetry, trace_every=trace_every,
                      trace_len=trace_len, device=device)
    seed_l, mpl_l, rt_l = grid_lanes(figs, mpl_grid, seeds, fleet.device)
    flat = fleet.run_lanes(seed_l, mpl_l, rt_l)
    shape = (len(figs), len(mpl_grid), len(seeds))
    out = {fig: {proto: _fold(res, lambda v, i=i:
                              v.reshape(shape + v.shape[1:])[i])
                 for proto, res in flat.items()}
           for i, fig in enumerate(figs)}
    return out, fleet
