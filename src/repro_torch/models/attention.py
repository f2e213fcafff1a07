"""GQA self- and cross-attention with RoPE and qk-norm: the port of
``repro/models/attention.py``.

The branches of the reference's ``attention()``:

* **decode** (``:294``): one new token; its k/v are written into the
  cache at ``cache_pos`` and the token attends over the cached slots
  through ``_sdpa`` (``:237``), plain torch as in the reference, which
  computes it outside any Pallas kernel.  The mask comes from the
  absolute position stored per slot, so one code serves a linear cache
  and a sliding-window ring (``cfg.sliding_window``: a slot is seen only
  while ``pos > abs_pos - window``).  An int8 cache (``cache_dtype=
  "int8"``) stores each token's k and v as codes with one float32 scale
  per (token, head) (``_quantize``) and dequantises the whole cache in
  the compute dtype before ``_sdpa`` (``_dequant``), as the reference.
* **kv_override** (``:277``): decode against precomputed k and v (the
  vlm family's cross-attention caches of the image tokens): q alone is
  projected, qk-normed and not rotated, and attends over every given key
  through the same plain ``_sdpa``, with no mask.
* **full sequence** (``:328`` and ``:342``): the prefill and the
  backbone, causal or not (``cfg.causal``; hubert's encoder is not), and
  cross-attention (``xs``: k and v projected from the source, no RoPE on
  q or k, no mask).  It goes through ``kernels.ops.flash_attention``, the
  hand-written CUDA kernel on the card (the reference names its Pallas
  ``flash_attention`` for this branch under either ``attn_impl``) and
  its plain version on the CPU, with the sliding window as the kernel's
  ``window`` of a causal self-attention; cross-attention (Sq != Sk) and
  non-causal self-attention take no mask and no window, as the
  reference's ``cross or not cfg.causal`` (``:344``).  The kernel reads q, k and v in the model's ``[B, S, H, Dh]``
  layout through strides and writes its output in that layout.  The
  cache it returns holds k and v in the compute dtype whatever
  ``cache_dtype`` is: the reference's prefill does not quantise
  (``:334-337``, ``:358-362``), and the port keeps that behaviour.

The sharding pins ``_pin`` and ``_dax`` are ``parallel.sharding``'s
``pin`` and ``dax``: without an ambient mesh a pin returns its input, as
the reference's does; under one it redistributes a DTensor and returns a
local tensor as it is, so it never changes a value.  The reference pins
its XLA twin of the kernel (``_sdpa_chunked``), which the port does not
have; ``models.rwkv`` pins its WKV operands with them.

Query heads can be padded (``pad_q_heads``): the padded heads' rows of
``wo`` are zeroed, so they are exact no-ops.  KV heads are replicated
``kv_repeat`` times after projection with ``repeat_interleave`` (the
reference's ``jnp.repeat``), so query head h reads KV head h // g.

The decode branch updates the cache **in place** (the reference returns
a new cache; its serving loop donates the old one), and returns it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import ops
from ..parallel import sharding
from . import layers
from .config import ModelConfig

NEG = -1e30                       # the reference's masked score


class KVCache(NamedTuple):
    k: torch.Tensor               # [B, Smax, H_eff, Dh]  (cache dtype)
    v: torch.Tensor
    pos: torch.Tensor             # int32[Smax] absolute position per slot
                                  # (-1 = empty); linear or ring layout
    k_scale: Optional[torch.Tensor] = None   # [B, Smax, H_eff, 1] float32
    v_scale: Optional[torch.Tensor] = None   # (int8 cache only)


def effective_kv_heads(cfg: ModelConfig, kv_repeat: int) -> int:
    return cfg.n_kv_heads * kv_repeat


def _pin(x: torch.Tensor, axes):
    """``x`` pinned to ``axes`` under the ambient mesh (``sharding.pin``);
    ``x`` itself without one."""
    return sharding.pin(x, axes)


def _dax():
    """The ambient mesh's data axes, ``None`` without one."""
    return sharding.dax()


class Attention(torch.nn.Module):
    """``attn_init``: ``wq [d, Hq*Dh]``, ``wk``/``wv [d, Hkv*Dh]``,
    ``wo [Hq*Dh, d]``, and ``q_norm``/``k_norm [Dh]`` with qk-norm."""

    def __init__(self, cfg: ModelConfig, device, *, pad_q_heads: int = 0):
        super().__init__()
        d, dh = cfg.d_model, cfg.head_dim
        hq = pad_q_heads or cfg.n_heads
        hkv = cfg.n_kv_heads
        dt = layers.dtype_of(cfg.param_dtype)
        self.live_rows = min(cfg.n_heads, hq) * dh
        self.wq = layers.param((d, hq * dh), dt, device)
        self.wk = layers.param((d, hkv * dh), dt, device)
        self.wv = layers.param((d, hkv * dh), dt, device)
        self.wo = layers.param((hq * dh, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = layers.param((dh,), dt, device)
            self.k_norm = layers.param((dh,), dt, device)

    def init(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            layers.dense_init(w, gen)
        layers.dense_init(self.wo, gen, scale=self.wo.shape[0] ** -0.5)
        with torch.no_grad():
            self.wo[self.live_rows:].zero_()     # padded heads: no-ops
            if hasattr(self, "q_norm"):
                self.q_norm.fill_(1)
                self.k_norm.fill_(1)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               kv_repeat: int = 1, cache_dtype: str = "bfloat16",
               device=None) -> KVCache:
    """Zeroed cache, every slot empty: bf16 (or float32/float16) k/v, or
    int8 codes with float32 scales of one."""
    h = effective_kv_heads(cfg, kv_repeat)
    shape = (batch, max_seq, h, cfg.head_dim)
    pos = torch.full((max_seq,), -1, dtype=torch.int32, device=device)
    if cache_dtype == "int8":
        scale = (batch, max_seq, h, 1)
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       pos=pos,
                       k_scale=torch.ones(scale, dtype=torch.float32,
                                          device=device),
                       v_scale=torch.ones(scale, dtype=torch.float32,
                                          device=device))
    dt = layers.dtype_of(cache_dtype)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device), pos=pos)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and float32 scales over the last axis: the scale is
    ``max|x| / 127 + 1e-8`` and the code ``round(x / scale)`` (half to
    even, as ``jnp.round``) clipped to +-127."""
    x = x.float()
    scale = x.abs().amax(-1, keepdim=True) / 127.0 + 1e-8
    q = torch.round(x / scale).clamp_(-127, 127)
    return q.to(torch.int8), scale


def _dequant(q: torch.Tensor, scale: Optional[torch.Tensor], dtype
             ) -> torch.Tensor:
    """Codes times scales, both cast to the compute dtype first (the
    reference's choice: half the bytes of a float32 dequant in bf16);
    without scales, a plain cast."""
    if scale is None:
        return q.to(dtype)
    return q.to(dtype) * scale.to(dtype)


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 xs: Optional[torch.Tensor], positions: torch.Tensor,
                 kv_repeat: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns q ``[B,S,Hq,Dh]``, k/v ``[B,T,H_eff,Dh]``: k and v from the
    cross source ``xs`` if given (and then no RoPE), else from ``x``
    with RoPE on q and k."""
    dh = cfg.head_dim
    src = x if xs is None else xs
    q = (x @ p.wq).unflatten(-1, (-1, dh))
    k = (src @ p.wk).unflatten(-1, (-1, dh))
    v = (src @ p.wv).unflatten(-1, (-1, dh))
    if cfg.qk_norm:
        q = layers.rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = layers.rmsnorm(k, p.k_norm, cfg.norm_eps)
    if xs is None:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=2)
        v = v.repeat_interleave(kv_repeat, dim=2)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped scaled-dot-product attention (the reference's ``_sdpa``).

    q ``[B,S,Hq,Dh]``, k/v ``[B,T,Hkv,Dh]`` with Hq = G * Hkv; mask
    broadcastable to ``[B,1,1,S,T]`` (True = attend).  Scores in the
    input dtype then float32; the softmax weights are cast to v's dtype
    before the PV product, as the reference does."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores * (dh ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(b, s, hq * dh)


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, kv_repeat: int = 1,
              xs: Optional[torch.Tensor] = None,
              cache: Optional[KVCache] = None, cache_pos: Optional[int] = None,
              return_cache: bool = False,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Self- or cross-attention.

    * full sequence (prefill, backbone): the flash kernel, causal as
      ``cfg.causal``; with ``return_cache`` the projected k/v become the
      cache.  With ``xs`` (``[B, T, d]``) it is cross-attention: k and v
      from ``xs``, no RoPE, no mask.
    * decode: x is ``[B, 1, d]``; ``cache`` holds the past and
      ``cache_pos`` (an int) is the write slot, clamped into the cache as
      ``dynamic_update_slice`` clamps it.
    * ``kv_override``: precomputed (k, v) ``[B, T, H_eff, Dh]``, attended
      by q alone with no mask (cross-attention decode against a static
      source).
    """
    if kv_override is not None:
        q = (x @ p.wq).unflatten(-1, (-1, cfg.head_dim))
        if cfg.qk_norm:
            q = layers.rmsnorm(q, p.q_norm, cfg.norm_eps)
        out = _sdpa(q, *kv_override, None)
        return out.to(x.dtype) @ p.wo, None
    q, k, v = _project_qkv(p, cfg, x, xs, positions, kv_repeat)
    b, s = x.shape[0], x.shape[1]
    cross = xs is not None
    new_cache = None

    if cache is not None and cache_pos is not None and s == 1:
        # --- decode step ---------------------------------------------------
        slot = min(max(int(cache_pos), 0), cache.k.shape[1] - 1)
        abs_pos = positions.reshape(()).to(torch.int32)
        cache.pos[slot] = abs_pos
        if cache.k.dtype == torch.int8:
            kq, ks = _quantize(k[:, 0])
            vq, vs = _quantize(v[:, 0])
            cache.k[:, slot] = kq
            cache.v[:, slot] = vq
            cache.k_scale[:, slot] = ks
            cache.v_scale[:, slot] = vs
        else:
            cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
            cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
        new_cache = cache
        valid = (cache.pos >= 0) & (cache.pos <= abs_pos)
        if cfg.sliding_window:
            valid &= cache.pos > abs_pos - cfg.sliding_window
        mask = valid[None, None, None, None, :]              # [1,1,1,1,T]
        out = _sdpa(q, _dequant(cache.k, cache.k_scale, q.dtype),
                    _dequant(cache.v, cache.v_scale, q.dtype), mask)
    else:
        # --- full sequence: the flash kernel, [B,H,S,D] views -------------
        # no mask at all for cross or non-causal attention, window included
        masked = cfg.causal and not cross
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=masked,
                                window=cfg.sliding_window if masked else 0)
        out = o.transpose(1, 2).reshape(b, s, -1)
        if return_cache:
            new_cache = KVCache(k=k, v=v, pos=positions.to(torch.int32)
                                .reshape(-1).expand(k.shape[1]).clone())
    y = out.to(x.dtype) @ p.wo
    return y, new_cache
