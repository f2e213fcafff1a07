"""Mixture-of-Experts layer: top-k router and sort-based capacity
dispatch, the port of ``repro/models/moe.py``.

Tokens are routed by a stable sort of their expert ids; each expert
computes a fixed-capacity ``[E, C, d]`` block (a token past its expert's
capacity is dropped, GShard/Switch semantics), and each token's outputs
are combined with its renormalised router gates.  An optional shared
expert (llama4) runs densely beside the routed ones, and the Switch
load-balance loss is returned beside the output.

The reference computes all of it with ``jnp`` outside any Pallas kernel,
and so does the port, in plain torch, step by step as the reference:

* the router in float32, its softmax, then the top k, lower index first
  on equal probabilities as ``jax.lax.top_k`` (a stable descending sort,
  since ``torch.topk`` promises no order among ties);
* the dispatch as a gather: slot ``p`` of expert ``e`` takes the
  ``p``-th of the sorted entries routed to ``e`` (the reference scatters
  each kept entry to its slot, which fills the same slots);
* the combine without atomics, so the card's result is the same on every
  run: each token's k contributions are gathered and added in the
  reference's order (expert id ascending, as its stable sort and its
  sequential scatter-add visit them), starting from zero.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..parallel import sharding
from . import layers
from .config import ModelConfig


class MoE(torch.nn.Module):
    """``moe_init``: ``router [d, E]`` (float32), ``wi_gate``/``wi_up
    [E, d, f]``, ``wo [E, f, d]``, and ``shared`` (an ``MLP``) with
    ``shared_expert``."""

    def __init__(self, cfg: ModelConfig, device, *,
                 shared_expert: bool = False):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = layers.dtype_of(cfg.param_dtype)
        self.router = layers.param((d, e), torch.float32, device)
        self.wi_gate = layers.param((e, d, f), dt, device)
        self.wi_up = layers.param((e, d, f), dt, device)
        self.wo = layers.param((e, f, d), dt, device)
        if shared_expert:
            self.shared = layers.MLP(d, f, dt, device)

    def init(self, gen: torch.Generator) -> None:
        layers.dense_init(self.router, gen)
        d, f = self.wi_gate.shape[1], self.wi_gate.shape[2]
        layers.trunc_normal_(self.wi_gate, gen, d ** -0.5)
        layers.trunc_normal_(self.wi_up, gen, d ** -0.5)
        layers.trunc_normal_(self.wo, gen, f ** -0.5)
        if hasattr(self, "shared"):
            self.shared.init(gen)


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``n k cf / E`` cut to an int, padded to a
    multiple of 8, at least 8."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)      # pad to multiple of 8


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates, experts) ``[n, k]``: the k largest probabilities of each
    row in descending order, the lower expert id first among equal ones
    (``jax.lax.top_k``'s order)."""
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gate[:, :k], expert[:, :k]


def experts(p: MoE, xe: torch.Tensor) -> torch.Tensor:
    """The expert MLPs on the dispatched tokens ``xe [E, C, d]``: one
    batched product per weight, SwiGLU with the gate's SiLU in float32
    cast back to ``xe``'s dtype (the reference's ``einsum``s)."""
    g = torch.bmm(xe, p.wi_gate)
    u = torch.bmm(xe, p.wi_up)
    return torch.bmm(F.silu(g.float()).to(xe.dtype) * u, p.wo)


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> (y ``[B, S, d]``, aux loss float32 0-d).

    On a mesh the experts are split over ``model`` (EP): the router is
    replicated, so every rank routes every token alike (the capacity from
    all of them), fills the slots of its ``E / n`` experts only, and
    combines their outputs into its part of ``y``; the shared expert's
    part (a column- and row-parallel MLP) is added and the sum reduced
    once.  Activations are replicated over ``model``, so no all-to-all
    is needed.

    With more than one data shard (``sharding.dp_of``) the dispatch is the
    global batch's, as the reference's under GSPMD: the capacity comes
    from every shard's tokens, an entry's place in its expert counts the
    entries of the shards before it (one all-reduce of a ``[shards, E]``
    table of counts), and the load-balance loss is the global batch's
    (its statistics summed over the shards)."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    dp = sharding.dp_of(p.router)
    c = capacity(n * (dp.size if dp else 1), cfg)
    xf = x.reshape(n, d)
    dev = x.device
    tp = layers.model_split(p.wi_gate)
    el = p.wi_gate.shape[0]                  # this rank's experts
    e0 = tp.index * el if tp else 0

    logits = xf.float() @ p.router
    probs = torch.softmax(logits, dim=-1)                      # [n, e]
    gate, expert = route(probs, k)                             # [n, k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch-style load-balance aux loss
    top1 = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, expert[:, 0], torch.ones_like(expert[:, 0]))       # no host sync
    if dp is None:
        density = top1.float() / n
        density_proxy = probs.mean(0)
    else:
        density = sharding.dp_sum(top1, dp).float() / (n * dp.size)
        density_proxy = sharding.dp_sum(probs.sum(0), dp) / (n * dp.size)
    aux = (density * density_proxy).sum() * (e ** 2) / e

    # ---- sort-based dispatch -------------------------------------------
    flat_expert = expert.reshape(-1)                           # [n*k]
    order = torch.sort(flat_expert, stable=True).indices       # [n*k]
    sorted_expert = flat_expert[order]
    seg_start = torch.searchsorted(
        sorted_expert, torch.arange(e + 1, device=dev, dtype=expert.dtype),
        side="left")                                           # [e+1]
    pos_in_expert = torch.arange(n * k, device=dev) - seg_start[sorted_expert]
    ahead = torch.zeros(e, dtype=seg_start.dtype, device=dev)
    if dp is not None:           # the earlier shards' entries of each expert
        table = torch.zeros((dp.size, e), dtype=seg_start.dtype, device=dev)
        table[dp.index] = seg_start[1:] - seg_start[:-1]
        ahead = sharding.dp_sum(table, dp)[:dp.index].sum(0)
    keep = pos_in_expert + ahead[sorted_expert] < c
    if tp:                            # an entry of another rank's expert
        keep_here = keep & (sorted_expert >= e0) & (sorted_expert < e0 + el)
    else:
        keep_here = keep
    slot = torch.where(keep_here, (sorted_expert - e0) * c + pos_in_expert,
                       el * c)
    token_id = order // k                                      # [n*k]

    # slot (e, q) holds the sorted entry seg_start[e] + q while q < the
    # expert's count: the reference's scatter of xf[token_id] to slot
    q = torch.arange(c, device=dev)
    entry = seg_start[e0:e0 + el, None] + q
    filled = (entry < seg_start[e0 + 1:e0 + el + 1, None]) & \
        (q + ahead[e0:e0 + el, None] < c)                      # [el, c]
    src = token_id[entry.clamp_max(n * k - 1)]
    xe = torch.where(filled[..., None], sharding.tp_copy(xf, tp)[src],
                     torch.zeros((), dtype=x.dtype, device=dev))  # [el, c, d]

    ye = experts(p, xe)                                        # [el, c, d]

    # ---- combine ---------------------------------------------------------
    ye_flat = torch.cat([ye.reshape(el * c, d), ye.new_zeros((1, d))])
    w = sharding.tp_copy((gate.reshape(-1)[order] * keep).to(x.dtype), tp)
    # each token's sorted entries in expert-id order: the order in which
    # the reference's scatter-add meets them
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n * k, device=dev)
    by_id = rank.reshape(n, k).sort(dim=-1).values             # [n, k]
    parts = ye_flat[slot[by_id]] * w[by_id][..., None]         # [n, k, d]
    y = torch.zeros((n, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + parts[:, j]

    if hasattr(p, "shared"):
        ts = layers.model_split(p.shared.wi_gate)
        ys = layers.mlp_apply(p.shared, xf, reduce=False)
        if (ts is None) != (tp is None):     # one part, one whole output
            y, ys = sharding.tp_reduce(y, tp), sharding.tp_reduce(ys, ts)
            tp = None
        y = y + ys
    y = sharding.tp_reduce(y, tp)
    return y.reshape(b, s, d), aux.float()
