"""Mamba2 (SSD) block of the hybrid family (zamba2): the port of
``repro/models/ssm.py``.

Chunked state-space duality: within a chunk of Q tokens the output is a
masked quadratic form; across chunks a small recurrent state ``[H, P,
N]`` per batch row is carried.  Decode is an O(1) single-token update.

State conventions per head h:
    h_t = exp(-dt_t * A_h) * h_{t-1} + dt_t * (x_t outer B_t)   [P, N]
    y_t = (h_t @ C_t) + D_h * x_t
with dt_t = softplus(dt_raw + dt_bias), A_h = exp(A_log_h) > 0.

The reference computes all of this in plain ``jnp`` outside any Pallas
kernel, so plain torch is its port.  It walks the chunks with a
``lax.scan`` that computes each chunk's terms in turn; here the terms
that do not depend on the carried state (the intra-chunk quadratic form,
each chunk's own state increment) are computed for every chunk at once,
and only the ``[B, H, P, N]`` recurrence walks the chunks in order
(``ssd_chunked``).  The sums are the reference's, taken in another order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import layers
from .config import ModelConfig


class SSMSpec(NamedTuple):
    d_inner: int
    n_heads: int
    head_dim: int
    state: int
    conv: int
    chunk: int


def spec(cfg: ModelConfig) -> SSMSpec:
    d_inner = cfg.ssm_expand * cfg.d_model
    head_dim = cfg.ssm_head_dim or 64
    n_heads = cfg.ssm_heads or d_inner // head_dim
    return SSMSpec(d_inner, n_heads, head_dim, cfg.ssm_state,
                   cfg.ssm_conv, cfg.ssm_chunk)


class Mamba2(torch.nn.Module):
    """``mamba2_init``: split projections ``wz``, ``wxs`` ``[d, d_inner]``,
    ``wBC [d, 2N]``, ``wdt [d, H]``; depthwise conv taps ``conv_xs``
    ``[conv, d_inner]``, ``conv_BC [conv, 2N]`` and bias ``conv_b``;
    ``A_log``, ``D``, ``dt_bias [H]`` in float32 whatever the parameter
    dtype; gate norm ``norm_g [d_inner]``; ``out_proj [d_inner, d]``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        sp = spec(cfg)
        d = cfg.d_model
        dt = layers.dtype_of(cfg.param_dtype)
        f32 = torch.float32
        self.wz = layers.param((d, sp.d_inner), dt, device)
        self.wxs = layers.param((d, sp.d_inner), dt, device)
        self.wBC = layers.param((d, 2 * sp.state), dt, device)
        self.wdt = layers.param((d, sp.n_heads), dt, device)
        self.conv_xs = layers.param((sp.conv, sp.d_inner), dt, device)
        self.conv_BC = layers.param((sp.conv, 2 * sp.state), dt, device)
        self.conv_b = layers.param((sp.d_inner + 2 * sp.state,), dt, device)
        self.A_log = layers.param((sp.n_heads,), f32, device)
        self.D = layers.param((sp.n_heads,), f32, device)
        self.dt_bias = layers.param((sp.n_heads,), f32, device)
        self.norm_g = layers.param((sp.d_inner,), dt, device)
        self.out_proj = layers.param((sp.d_inner, d), dt, device)

    def init(self, gen: torch.Generator) -> None:
        """The reference's distributions: fan-in truncated normals for the
        projections, ``N(0, 1) / sqrt(conv)`` conv taps, a zero bias,
        ``A_log = log(linspace(1, 16, H))``, ``D = 1``, ``dt_bias`` the
        inverse softplus of ``linspace(1e-3, 0.1, H)``, a unit norm."""
        for w in (self.wz, self.wxs, self.wBC, self.wdt):
            layers.dense_init(w, gen)
        for w in (self.conv_xs, self.conv_BC):
            layers.normal_init(w, gen, w.shape[0] ** -0.5)
        layers.dense_init(self.out_proj, gen,
                          scale=self.out_proj.shape[0] ** -0.5)
        h = self.A_log.shape[0]
        dev = self.A_log.device
        with torch.no_grad():
            self.conv_b.zero_()
            self.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, h, dtype=torch.float32, device=dev)))
            self.D.fill_(1)
            self.dt_bias.copy_(torch.log(torch.expm1(torch.linspace(
                1e-3, 1e-1, h, dtype=torch.float32, device=dev))))
            self.norm_g.fill_(1)


class SSMCache(NamedTuple):
    conv: torch.Tensor    # [B, conv-1, conv_dim] rolling conv window
    state: torch.Tensor   # [B, H, P, N] float32 recurrent state


def init_ssm_cache(cfg: ModelConfig, batch: int, device=None) -> SSMCache:
    sp = spec(cfg)
    conv_dim = sp.d_inner + 2 * sp.state
    return SSMCache(
        conv=torch.zeros((batch, sp.conv - 1, conv_dim),
                         dtype=layers.dtype_of(cfg.compute_dtype),
                         device=device),
        state=torch.zeros((batch, sp.n_heads, sp.head_dim, sp.state),
                          dtype=torch.float32, device=device))


def _split_proj(p: Mamba2, x: torch.Tensor):
    """(z, xBC = [xs, B, C] along the last axis, dt_raw)."""
    z = x @ p.wz
    xBC = torch.cat([x @ p.wxs, x @ p.wBC], dim=-1)
    return z, xBC, x @ p.wdt


def _conv_w(p: Mamba2) -> torch.Tensor:
    return torch.cat([p.conv_xs, p.conv_BC], dim=1)


def _conv_with_history(p: Mamba2, xfull: torch.Tensor, s: int, sp: SSMSpec
                       ) -> torch.Tensor:
    """The depthwise conv over the last ``s`` positions of ``xfull``, given
    ``conv - 1`` positions of history before them: taps summed in the
    reference's order i = 0 .. conv-1, in the input dtype; then the bias
    and SiLU in float32, cast back."""
    w = _conv_w(p)
    out = xfull[:, 0:s, :] * w[0]
    for i in range(1, sp.conv):
        out = out + xfull[:, i:i + s, :] * w[i]
    return F.silu((out + p.conv_b).float()).to(xfull.dtype)


def _causal_conv(p: Mamba2, xBC: torch.Tensor, sp: SSMSpec) -> torch.Tensor:
    """Depthwise causal conv over ``[B, S, C]`` with kernel ``sp.conv``
    (zero history)."""
    pad = F.pad(xBC, (0, 0, sp.conv - 1, 0))
    return _conv_with_history(p, pad, xBC.shape[1], sp)


def _gates(p: Mamba2, dt_raw: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dt ``[..., H]`` float32, log_a ``[..., H]`` float32 <= 0);
    softplus as ``logaddexp(x, 0)``, the reference's form."""
    x = dt_raw.float() + p.dt_bias
    dt = torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))
    return dt, -dt * torch.exp(p.A_log)


def ssd_chunked(xh: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                dt: torch.Tensor, log_a: torch.Tensor, chunk: int,
                state0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan in float32.  xh ``[b, s, h, p]``, B and C
    ``[b, s, n]``, dt and log_a ``[b, s, h]``, ``s`` a multiple of
    ``chunk``; state0 ``[b, h, p, n]`` (zeros if None).  Returns (y
    ``[b, s, h, p]`` without the D skip, the final state)."""
    b, s, h, p_ = xh.shape
    n = B.shape[-1]
    q, nc = chunk, s // chunk
    x = xh.float().reshape(b, nc, q, h, p_)
    Bc = B.float().reshape(b, nc, q, n)
    Cc = C.float().reshape(b, nc, q, n)
    dtc = dt.reshape(b, nc, q, h)
    cum = torch.cumsum(log_a.reshape(b, nc, q, h), dim=2)   # [b,c,q,h]
    # intra-chunk: y[t] = sum_{u<=t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    ch = cum.permute(0, 1, 3, 2)                             # [b,c,h,q]
    w = (ch[..., :, None] - ch[..., None, :]).masked_fill_(
        ~tri, float("-inf")).exp_()                          # [b,c,h,t,u]
    cb = torch.einsum("bctn,bcun->bctu", Cc, Bc)             # [b,c,t,u]
    w.mul_(cb[:, :, None]).mul_(dtc.permute(0, 1, 3, 2)[..., None, :])
    y = torch.matmul(w, x.permute(0, 1, 3, 2, 4))           # [b,c,h,t,p]
    del w
    # each chunk's own state increment: sum_u exp(cum_last - cum_u) dt_u
    # x_u outer B_u
    last = cum[:, :, -1:, :]                                 # [b,c,1,h]
    wu = torch.exp(last - cum) * dtc                         # [b,c,q,h]
    dstate = torch.einsum("bcqh,bcqhp,bcqn->bchpn", wu, x, Bc)
    decay = torch.exp(last[:, :, 0, :])                      # [b,c,h]
    # the recurrence over chunks: the state entering each chunk
    state = (torch.zeros((b, h, p_, n), dtype=torch.float32,
                         device=xh.device) if state0 is None
             else state0.float())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = decay[:, c, :, None, None] * state + dstate[:, c]
    states = torch.stack(entering, dim=1)                    # [b,c,h,p,n]
    y_state = torch.einsum("bchpn,bctn->bchtp", states, Cc) \
        * torch.exp(ch)[..., None]
    y = (y + y_state).permute(0, 1, 3, 2, 4).reshape(b, s, h, p_)
    return y, state


def _gated_out(p: Mamba2, cfg: ModelConfig, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm, then the out-projection."""
    y = layers.rmsnorm(y * F.silu(z.float()).to(y.dtype), p.norm_g,
                       cfg.norm_eps)
    return y @ p.out_proj


def mamba2_forward(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                   cache: Optional[SSMCache] = None
                   ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Full-sequence chunked forward: x ``[B, S, d]`` -> y ``[B, S, d]``.

    With ``cache`` the conv window and state start from it and the final
    ones are returned (a prefill); ``S`` must be a multiple of the chunk
    (or shorter than one)."""
    sp = spec(cfg)
    b, s, _ = x.shape
    q = min(sp.chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    z, xBC, dt_raw = _split_proj(p, x)
    if cache is not None:
        full = torch.cat([cache.conv, xBC], dim=1)
        xBC_conv = _conv_with_history(p, full[:, -(s + sp.conv - 1):], s, sp)
        new_conv = full[:, -(sp.conv - 1):]
    else:
        xBC_conv = _causal_conv(p, xBC, sp)
    h, p_, n = sp.n_heads, sp.head_dim, sp.state
    xs = xBC_conv[..., :sp.d_inner]
    B = xBC_conv[..., sp.d_inner:sp.d_inner + n]
    C = xBC_conv[..., sp.d_inner + n:]
    dt, log_a = _gates(p, dt_raw)
    xh = xs.reshape(b, s, h, p_)
    y, final_state = ssd_chunked(
        xh, B, C, dt, log_a, q,
        cache.state if cache is not None else None)
    y = y + p.D[:, None] * xh.float()
    y = y.reshape(b, s, h * p_).to(x.dtype)
    out = _gated_out(p, cfg, y, z)
    new_cache = None
    if cache is not None:
        new_cache = SSMCache(conv=new_conv, state=final_state)
    return out, new_cache


def mamba2_decode(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                  cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """Single-token decode: x ``[B, 1, d]`` -> (y ``[B, 1, d]``, the new
    cache; the old one is not modified)."""
    sp = spec(cfg)
    b = x.shape[0]
    z, xBC, dt_raw = _split_proj(p, x)
    window = torch.cat([cache.conv, xBC], dim=1)             # [B, conv, C]
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            _conv_w(p).float())
    xBC_conv = F.silu(conv_out + p.conv_b.float()).to(x.dtype)[:, None, :]
    h, p_, n = sp.n_heads, sp.head_dim, sp.state
    xs = xBC_conv[..., :sp.d_inner]
    B = xBC_conv[:, 0, sp.d_inner:sp.d_inner + n].float()
    C = xBC_conv[:, 0, sp.d_inner + n:].float()
    dt, log_a = _gates(p, dt_raw)                            # [b,1,h]
    xh = xs.reshape(b, h, p_).float()
    a = torch.exp(log_a[:, 0, :])                            # [b,h]
    dstate = (dt[:, 0, :, None] * xh)[..., None] * B[:, None, None, :]
    state = a[:, :, None, None] * cache.state + dstate
    y = torch.einsum("bhpn,bn->bhp", state, C)
    y = y + p.D[:, None] * xh
    y = y.reshape(b, 1, h * p_).to(x.dtype)
    return _gated_out(p, cfg, y, z), SSMCache(conv=window[:, 1:],
                                              state=state)
