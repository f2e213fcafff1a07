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
    """x ``[B, S, d]`` -> (y ``[B, S, d]``, aux loss float32 0-d)."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(n, cfg)
    xf = x.reshape(n, d)
    dev = x.device

    logits = xf.float() @ p.router
    probs = torch.softmax(logits, dim=-1)                      # [n, e]
    gate, expert = route(probs, k)                             # [n, k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch-style load-balance aux loss
    top1 = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, expert[:, 0], torch.ones_like(expert[:, 0]))       # no host sync
    density = top1.float() / n
    density_proxy = probs.mean(0)
    aux = (density * density_proxy).sum() * (e ** 2) / e

    # ---- sort-based dispatch -------------------------------------------
    flat_expert = expert.reshape(-1)                           # [n*k]
    order = torch.sort(flat_expert, stable=True).indices       # [n*k]
    sorted_expert = flat_expert[order]
    seg_start = torch.searchsorted(
        sorted_expert, torch.arange(e + 1, device=dev, dtype=expert.dtype),
        side="left")                                           # [e+1]
    pos_in_expert = torch.arange(n * k, device=dev) - seg_start[sorted_expert]
    keep = pos_in_expert < c
    slot = torch.where(keep, sorted_expert * c + pos_in_expert, e * c)
    token_id = order // k                                      # [n*k]

    # slot (e, q) holds the sorted entry seg_start[e] + q while q < the
    # expert's count: the reference's scatter of xf[token_id] to slot
    entry = seg_start[:e, None] + torch.arange(c, device=dev)  # [e, c]
    filled = entry < seg_start[1:, None]
    src = token_id[entry.clamp_max(n * k - 1)]
    xe = torch.where(filled[..., None], xf[src],
                     torch.zeros((), dtype=x.dtype, device=dev))  # [e, c, d]

    ye = experts(p, xe)                                        # [e, c, d]

    # ---- combine ---------------------------------------------------------
    ye_flat = torch.cat([ye.reshape(e * c, d), ye.new_zeros((1, d))])
    w = (gate.reshape(-1)[order] * keep).to(x.dtype)           # [n*k]
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
        y = y + layers.mlp_apply(p.shared, xf)
    return y.reshape(b, s, d), aux.float()
