"""Building blocks: norms, RoPE, linear/embedding initialisers, SwiGLU,
the losses.

The port of ``repro/models/layers.py``.  Weights keep the
reference's ``[d_in, d_out]`` layout and are applied as ``x @ w``, so a
tensor carries over from the JAX package unchanged
(``models.convert``).  Every initialiser takes an explicit
``torch.Generator`` and writes in place into a tensor the caller owns;
compute happens in ``cfg.compute_dtype`` with float32 inside norms and
activations, as in the reference.  Parameters are created
inference-only (``param``); ``trainable`` makes a model's float
parameters require grad for training, and serving runs under
``torch.inference_mode()`` whatever they say.  The losses
(``softmax_cross_entropy``, ``chunked_cross_entropy``) are float32, as
the reference's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel import sharding

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise NotImplementedError(
            f"dtype {name!r} is not ported (ROADMAP.md, queue 1)") from None


def trunc_normal_(w: torch.Tensor, gen: torch.Generator,
                  scale: float) -> torch.Tensor:
    """Fill ``w`` with a normal truncated at +-3 sigma, times ``scale``:
    drawn in float32 by inverting the CDF of a uniform draw from ``gen``
    (on ``w``'s device), then cast to ``w``'s dtype."""
    lo, hi = (1 + math.erf(-3 / math.sqrt(2))) / 2, \
        (1 + math.erf(3 / math.sqrt(2))) / 2
    t = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    t.erfinv_().mul_(math.sqrt(2) * scale).clamp_(-3 * scale, 3 * scale)
    with torch.no_grad():
        w.copy_(t)
    return w


def dense_init(w: torch.Tensor, gen: torch.Generator,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init of a ``[d_in, d_out]`` weight."""
    return trunc_normal_(w, gen, scale if scale is not None
                         else w.shape[0] ** -0.5)


def embed_init(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``[vocab, d]`` embedding: truncated normal at ``d ** -0.5``."""
    return trunc_normal_(w, gen, w.shape[1] ** -0.5)


def normal_init(w: torch.Tensor, gen: torch.Generator,
                scale: float) -> torch.Tensor:
    """Plain normal times ``scale`` (the reference's ``mix_B``, ``wB``,
    ``u``), drawn in float32."""
    t = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    t.normal_(0.0, 1.0, generator=gen).mul_(scale)
    with torch.no_grad():
        w.copy_(t)
    return w


def param(shape, dtype, device) -> torch.nn.Parameter:
    """An uninitialised parameter, inference-only until ``trainable``."""
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                              requires_grad=False)


def trainable(module: torch.nn.Module) -> torch.nn.Module:
    """Make every float parameter of ``module`` require grad; returns the
    module."""
    for p in module.parameters():
        if p.is_floating_point():
            p.requires_grad_(True)
    return module


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm over the last axis in float32, cast back to ``x``'s dtype.
    A ``g`` sharded over ``model`` (a view of ``sharding.local_view``)
    means ``x`` holds this rank's columns of a wider axis: the sum of
    squares is summed over the ranks and divided by the whole width."""
    dt = x.dtype
    x = x.float()
    tp = sharding.tp_of(g)
    if tp is not None and tp.sharded:
        ss = sharding.tp_sum_stat((x * x).sum(-1, keepdim=True), tp)
        x = x * torch.rsqrt(ss / (x.shape[-1] * tp.size) + eps)
    else:
        x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * g.float()).to(dt)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    """Inverse frequencies, float32 ``[head_dim // 2]``."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: ``[..., S, H, Dh]``; positions broadcastable to ``[..., S]``.
    The head dimension is split in halves (not interleaved pairs)."""
    dh = x.shape[-1]
    inv = rope_frequencies(dh, theta, x.device)                # [Dh/2]
    ang = positions[..., :, None].float() * inv                # [..., S, Dh/2]
    sin = torch.sin(ang)[..., :, None, :]                      # [..., S, 1, Dh/2]
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

class MLP(torch.nn.Module):
    """``mlp_init``'s three weights: ``wi_gate``, ``wi_up`` ``[d, f]`` and
    ``wo`` ``[f, d]``."""

    def __init__(self, d: int, f: int, dtype, device):
        super().__init__()
        self.wi_gate = param((d, f), dtype, device)
        self.wi_up = param((d, f), dtype, device)
        self.wo = param((f, d), dtype, device)

    def init(self, gen: torch.Generator) -> None:
        dense_init(self.wi_gate, gen)
        dense_init(self.wi_up, gen)
        dense_init(self.wo, gen, scale=self.wo.shape[0] ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x)


def model_split(w: torch.Tensor) -> Optional["sharding.TP"]:
    """``w``'s ``TP`` where the rules shard it over ``model``, else
    ``None`` (an unsharded model, a one-rank ``model`` axis, or a dim the
    axis does not divide, which every rank computes whole)."""
    tp = sharding.tp_of(w)
    return tp if tp is not None and tp.sharded else None


def mlp_apply(p: MLP, x: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """SwiGLU; on a mesh the gate and up products are column-parallel and
    ``wo`` row-parallel, with one reduction over ``model`` (none with
    ``reduce=False``: the caller adds this rank's part to others first
    and reduces the sum)."""
    tp = model_split(p.wi_gate)
    x = sharding.tp_copy(x, tp)
    g = x @ p.wi_gate
    u = x @ p.wi_up
    h = F.silu(g.float()).to(x.dtype) * u
    y = h @ p.wo
    return sharding.tp_reduce(y, tp) if reduce else y



# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _nll(logits: torch.Tensor, labels: torch.Tensor, tp=None
         ) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` in float32.  With a ``tp``
    the logits are this rank's slice of the vocabulary (rank ``i`` holds
    ids ``[i V/n, (i+1) V/n)``): the max and the sum of exponentials are
    reduced over ``model`` and the label's logit comes from the rank that
    owns it, so the whole ``[..., V]`` logits are never gathered."""
    logits = logits.float()
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels[..., None].long())[..., 0]
        return lse - ll
    vl = logits.shape[-1]
    m = sharding.tp_max(logits.detach().amax(-1, keepdim=True), tp)
    se = sharding.tp_reduce(torch.exp(logits - m).sum(-1), tp)
    lse = torch.log(se) + m[..., 0]
    t = labels.long() - tp.index * vl
    inside = (t >= 0) & (t < vl)
    ll = logits.gather(-1, t.clamp(0, vl - 1)[..., None])[..., 0]
    ll = sharding.tp_reduce(torch.where(inside, ll, torch.zeros_like(ll)), tp)
    return lse - ll


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, tp=None):
    """Token-level CE in float32: logits ``[..., V]`` (a rank's vocabulary
    slice with a ``tp``, ``_nll``), labels ``[...]``; returns (the mean
    over the tokens the float ``mask`` keeps, the token count)."""
    nll = _nll(logits, labels, tp)
    if mask is not None:
        nll = nll * mask
        count = mask.float().sum()
    else:
        count = torch.tensor(float(nll.numel()), device=nll.device)
    return nll.sum() / count.clamp_min(1.0), count


def _chunk_ce(xc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor,
              mc: torch.Tensor, tp=None):
    nll = _nll(sharding.tp_copy(xc, tp) @ head, lc, tp) * mc
    return nll.sum(), mc.sum()


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, chunk: int,
                          mask: Optional[torch.Tensor] = None, tp=None):
    """CE over sequence chunks without holding the ``[B, S, V]`` logits:
    x ``[B, S, d]``, head ``[d, V]``.  Each chunk's logits, logsumexp and
    label logit are recomputed in the backward (a checkpoint per chunk, as
    the reference's ``@jax.checkpoint`` scan), so only ``[B, chunk, V]``
    logits live at once; with a ``tp``, ``head`` is ``[d, V / n]``, this
    rank's vocabulary (``_nll``).  Returns (mean loss, token count)."""
    b, s, _ = x.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"chunked_cross_entropy: S={s} is not a multiple "
                         f"of chunk={c}")
    mask = (torch.ones((b, s), dtype=torch.float32, device=x.device)
            if mask is None else mask.float())
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for i in range(0, s, c):
        args = (x[:, i:i + c], head, labels[:, i:i + c], mask[:, i:i + c],
                tp)
        nll, n = checkpoint(_chunk_ce, *args, use_reentrant=False) \
            if remat else _chunk_ce(*args)
        total = total + nll
        count = count + n
    return total / count.clamp_min(1.0), count
