"""Building blocks: norms, RoPE, linear/embedding initialisers, SwiGLU.

The port of ``repro/models/layers.py:22-95``.  Weights keep the
reference's ``[d_in, d_out]`` layout and are applied as ``x @ w``, so a
tensor carries over from the JAX package unchanged
(``models.convert``).  Every initialiser takes an explicit
``torch.Generator`` and writes in place into a tensor the caller owns;
compute happens in ``cfg.compute_dtype`` with float32 inside norms and
activations, as in the reference.  The losses wait for training.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

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
    """An uninitialised inference-only parameter."""
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                              requires_grad=False)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm over the last axis in float32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
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


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    g = x @ p.wi_gate
    u = x @ p.wi_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p.wo
