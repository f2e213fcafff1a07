"""RWKV6 "Finch" blocks (attention-free, data-dependent decay): the port
of ``repro/models/rwkv.py``.

* time-mixing with data-dependent token-shift interpolation (ddlerp via
  a low-rank "mix LoRA"),
* per-channel data-dependent decay ``w = exp(-exp(w0 + lora_w(x)))``,
* per-head WKV state recurrence with bonus term ``u``:
      out_t = r_t @ (diag(u) k_t^T v_t + S_{t-1})
      S_t   = diag(w_t) S_{t-1} + k_t^T v_t
* gated output through a per-head-width RMSNorm,
* squared-ReLU channel mixing with receptance gate.

The full sequence (prefill, backbone) runs the chunked WKV
(``wkv_chunked``): on the card the hand-written CUDA kernel
(``kernels/wkv.py``), which reads r/k/v/log_w in the model's
``[B, S, H*D]`` layout through strides, on the CPU its plain version.
Decode is the O(1) recurrent update in plain torch.

The WKV heads may be padded (``rwkv_pad_heads``: rwkv6-3b's 40 heads of
64 become 48, ``dw`` = 3,072 > d = 2,560); the dead rows of ``wo`` are
zeroed, so the padded heads are exact no-ops.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import sharding
from . import attention as attn_mod
from . import layers
from .config import ModelConfig


class RWKVCache(NamedTuple):
    shift_t: torch.Tensor   # [B, 1, d] last token (time-mix shift)
    shift_c: torch.Tensor   # [B, 1, d] last token (channel-mix shift)
    state: torch.Tensor     # [B, H, dk, dv] float32 WKV state


def n_heads(cfg: ModelConfig) -> int:
    """WKV head count, padded to ``rwkv_pad_heads`` when that is larger."""
    return max(cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_pad_heads)


def wkv_width(cfg: ModelConfig) -> int:
    return n_heads(cfg) * cfg.rwkv_head_dim


def init_rwkv_cache(cfg: ModelConfig, batch: int, device=None) -> RWKVCache:
    d = cfg.d_model
    h, k = n_heads(cfg), cfg.rwkv_head_dim
    dt = layers.dtype_of(cfg.compute_dtype)
    return RWKVCache(
        shift_t=torch.zeros((batch, 1, d), dtype=dt, device=device),
        shift_c=torch.zeros((batch, 1, d), dtype=dt, device=device),
        state=torch.zeros((batch, h, k, k), dtype=torch.float32,
                          device=device))


class TimeMix(torch.nn.Module):
    """``time_mix_init``'s fourteen tensors."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dw = cfg.d_model, wkv_width(cfg)
        dt = layers.dtype_of(cfg.param_dtype)
        r, rm = cfg.rwkv_lora_w, cfg.rwkv_lora_mix
        f32 = torch.float32
        self.d = d
        self.mu_x = layers.param((d,), dt, device)
        self.mix_A = layers.param((d, rm * 5), dt, device)
        self.mix_B = layers.param((5, rm, d), dt, device)
        self.mu_rkvwg = layers.param((5, d), dt, device)
        self.wr = layers.param((d, dw), dt, device)
        self.wk = layers.param((d, dw), dt, device)
        self.wv = layers.param((d, dw), dt, device)
        self.wg = layers.param((d, dw), dt, device)
        self.wo = layers.param((dw, d), dt, device)
        self.w0 = layers.param((dw,), f32, device)
        self.wA = layers.param((d, r), dt, device)
        self.wB = layers.param((r, dw), dt, device)
        self.u = layers.param((dw,), f32, device)
        self.ln_g = layers.param((dw,), dt, device)

    def init(self, gen: torch.Generator) -> None:
        # the reference's key order: mix_A, mix_B, wr, wk, wv, wg, wo, wA,
        # wB, u (separate generators there, one stream here)
        layers.dense_init(self.mix_A, gen)
        layers.normal_init(self.mix_B, gen, 0.01)
        for w in (self.wr, self.wk, self.wv, self.wg):
            layers.dense_init(w, gen)
        layers.dense_init(self.wo, gen, scale=self.wo.shape[0] ** -0.5)
        layers.dense_init(self.wA, gen)
        layers.normal_init(self.wB, gen, 0.01)
        layers.normal_init(self.u, gen, 0.1)
        with torch.no_grad():
            self.wo[self.d:].zero_()           # dead WKV heads: no-ops
            self.mu_x.fill_(0.5)
            self.mu_rkvwg.fill_(0.5)
            self.w0.fill_(-6.0)
            self.ln_g.fill_(1)


class ChannelMix(torch.nn.Module):
    """``channel_mix_init``: ``mu_k``, ``mu_r``, ``wk [d, f]``,
    ``wv [f, d]``, ``wr [d, d]``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dt = layers.dtype_of(cfg.param_dtype)
        self.mu_k = layers.param((d,), dt, device)
        self.mu_r = layers.param((d,), dt, device)
        self.wk = layers.param((d, f), dt, device)
        self.wv = layers.param((f, d), dt, device)
        self.wr = layers.param((d, d), dt, device)

    def init(self, gen: torch.Generator) -> None:
        layers.dense_init(self.wk, gen)
        layers.dense_init(self.wv, gen, scale=self.wv.shape[0] ** -0.5)
        layers.dense_init(self.wr, gen)
        with torch.no_grad():
            self.mu_k.fill_(0.5)
            self.mu_r.fill_(0.5)


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1}; position 0 gets ``prev`` (or zeros)."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev.to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p: TimeMix, x: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """Data-dependent lerp producing the 5 mixed inputs ``[5, B, S, d]``."""
    base = x + (xx - x) * p.mu_x
    lora = base @ p.mix_A
    lora = torch.tanh(lora.float()).to(x.dtype)
    lora = lora.unflatten(-1, (5, -1))                       # [B,S,5,rm]
    delta = torch.einsum("bsfr,frd->fbsd", lora, p.mix_B)    # [5,B,S,d]
    mu = p.mu_rkvwg[:, None, None, :] + delta                # [5,B,S,d]
    return x[None] + (xx - x)[None] * mu


def _decay(p: TimeMix, xw: torch.Tensor, tp=None) -> torch.Tensor:
    """log w_t in (-inf, 0): data-dependent per-channel decay, float32
    (the rank's channels with a ``tp``: ``wB`` and ``w0`` split)."""
    lora = torch.tanh((xw @ p.wA).float())
    dd = sharding.tp_copy(lora, tp) @ p.wB.float()
    return -torch.exp(p.w0 + dd)


def _mixed(p: TimeMix, x: torch.Tensor, xx: torch.Tensor, tp):
    """``_ddlerp``'s (xr, xk, xv, xw, xg); with a ``tp`` all but ``xw``
    (which the replicated decay LoRA reads first) enter the model-parallel
    region in one collective."""
    mixed = _ddlerp(p, x, xx)
    if tp is None:
        return tuple(mixed)
    xr, xk, xv, xg = sharding.tp_copy(mixed[[0, 1, 2, 4]], tp)
    return xr, xk, xv, mixed[3], xg


def _split(p: TimeMix, cfg: ModelConfig):
    """The ``TP`` of a time-mix whose WKV heads split over ``model``."""
    tp = layers.model_split(p.wr)
    if tp is not None and n_heads(cfg) % tp.size:
        raise NotImplementedError(
            f"{n_heads(cfg)} WKV heads over model = {tp.size}: the shard "
            f"does not hold whole heads")
    return tp


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, u: torch.Tensor, head_dim: int,
                state0: Optional[torch.Tensor] = None, chunk: int = 128,
                pins: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV.  r/k/v ``[B,S,d]``; log_w ``[B,S,d]`` float32; u
    ``[d]`` float32.  Returns (out ``[B,S,d]`` float32, final state
    ``[B,H,dk,dk]`` float32).  ``S`` must be a multiple of
    ``min(chunk, S)``, as in the reference.

    The kernel (or its plain version) gets ``[B, H, S, D]`` views of the
    ``[B, S, H*D]`` tensors, strides and all, and writes its output in
    the ``[B, S, H, D]`` layout, so no copy is made either way.

    ``pins`` (``cfg.rwkv_wkv_pins``) pins the heads over ``model`` and
    the batch over the data axes, as the reference pins its chunk scan
    (``attention._pin``: nothing changes without an ambient mesh)."""
    b, s, d = r.shape
    h = d // head_dim
    dax = attn_mod._dax() if pins else None
    pin = attn_mod._pin if pins else (lambda x, spec: x)

    def heads(x):
        return pin(x.unflatten(-1, (h, head_dim)).transpose(1, 2),
                   (dax, "model", None, None))

    if state0 is not None:
        state0 = pin(state0, (dax, "model", None, None))
    out, state = ops.wkv_chunked(heads(r), heads(k), heads(v), heads(log_w),
                                 u.reshape(h, head_dim),
                                 chunk=min(chunk, s), state0=state0)
    out = pin(out, (dax, None, "model", None))
    state = pin(state, (dax, "model", None, None))
    return out.transpose(1, 2).reshape(b, s, d), state


def _gate_out(p: TimeMix, cfg: ModelConfig, out: torch.Tensor,
              g: torch.Tensor, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The norm over all of ``dw`` (on a mesh its statistic summed over
    the ranks' heads, the padded heads' zeros counted), the gate, and the
    row-parallel ``wo``."""
    out = layers.rmsnorm(out.to(x.dtype), p.ln_g, cfg.norm_eps)
    out = out * F.silu(g.float()).to(x.dtype)
    return sharding.tp_reduce(out @ p.wo, tp)


def time_mix_forward(p: TimeMix, cfg: ModelConfig, x: torch.Tensor,
                     cache_shift: Optional[torch.Tensor] = None,
                     state0: Optional[torch.Tensor] = None, pin=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y, final_state, last_token) for ``[B,S,d]`` input.

    ``cfg.rwkv_wkv_pins`` (or a ``pin``, ``act_constraints``) pins the
    widened WKV operands' channel dim over ``model`` (``pin_w``); no pin
    changes a value."""
    use_pins = cfg.rwkv_wkv_pins or pin is not None

    def pin_w(t):                    # [B, S, dw]: channel dim over model
        return sharding.constrain_act(t, last_model=True) if use_pins else t

    tp = _split(p, cfg)
    xx = _shift(x, cache_shift)
    xr, xk, xv, xw, xg = _mixed(p, x, xx, tp)
    r = pin_w(xr @ p.wr)
    k = pin_w(xk @ p.wk)
    v = pin_w(xv @ p.wv)
    g = pin_w(xg @ p.wg)
    log_w = pin_w(_decay(p, xw, tp))
    out, state = wkv_chunked(r, k, v, log_w, p.u, cfg.rwkv_head_dim,
                             state0=state0, pins=use_pins)
    return _gate_out(p, cfg, out, g, x, tp), state, x[:, -1:]


def time_mix_decode(p: TimeMix, cfg: ModelConfig, x: torch.Tensor,
                    shift_t: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) decode: x ``[B,1,d]``; on a mesh ``state`` holds the rank's
    heads."""
    tp = _split(p, cfg)
    h, hd = n_heads(cfg) // (tp.size if tp else 1), cfg.rwkv_head_dim
    b = x.shape[0]
    xx = shift_t.to(x.dtype)
    xr, xk, xv, xw, xg = _mixed(p, x, xx, tp)
    r = (xr @ p.wr).float()
    k = (xk @ p.wk).float()
    v = (xv @ p.wv).float()
    g = xg @ p.wg
    w = torch.exp(_decay(p, xw, tp))[:, 0]                 # [b,d]
    rh = r[:, 0].reshape(b, h, hd)
    kh = k[:, 0].reshape(b, h, hd)
    vh = v[:, 0].reshape(b, h, hd)
    wh = w.reshape(b, h, hd)
    uh = p.u.reshape(h, hd)
    kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
    out = torch.einsum("bhk,bhkv->bhv", rh,
                       state + uh[None, :, :, None] * kv)
    new_state = wh[..., None] * state + kv
    out = out.reshape(b, 1, h * hd)
    return _gate_out(p, cfg, out, g, x, tp), new_state, x[:, -1:]


def channel_mix_forward(p: ChannelMix, cfg: ModelConfig, x: torch.Tensor,
                        cache_shift: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared-ReLU channel mixing with its receptance gate.  On a mesh
    ``wk`` is column- and ``wv`` row-parallel, and the rules split the
    gate's ``wr [d, d]`` by columns too (the reference keeps that layout
    on purpose, ``repro/parallel/sharding.py:201-205``): ``wv``'s partial
    sums are reduced to the rank's columns, gated there, and the product
    all-gathered."""
    tk, tr = layers.model_split(p.wk), layers.model_split(p.wr)
    xx = _shift(x, cache_shift)
    xk = x + (xx - x) * p.mu_k
    xr = x + (xx - x) * p.mu_r
    k = sharding.tp_copy(xk, tk) @ p.wk
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = sharding.tp_reduce(k @ p.wv, tk)
    rgate = torch.sigmoid(sharding.tp_copy(xr, tr) @ p.wr)
    if tr is None:
        return rgate * kv, x[:, -1:]
    return sharding.tp_gather_last(rgate * sharding.tp_split_last(kv, tr),
                                   tr), x[:, -1:]
