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

On a mesh each rank computes its query heads and the KV heads they read
(``head_layout``): x enters the model-parallel region (``tp_copy``), the
flash kernel or the decode's ``_sdpa`` sees the rank's heads, and
``wo``'s row-parallel product is reduced over ``model``.

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


class Heads(NamedTuple):
    """A rank's share of the heads on a mesh (``head_layout``): the weights
    it projects with, the effective KV heads it computes (and caches) and,
    among them, the ones its query heads read.  ``tp`` is ``None`` where
    the rank computes the block whole."""
    tp: Optional[sharding.TP]
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    q_norm: Optional[torch.Tensor]
    k_norm: Optional[torch.Tensor]
    kv_heads: slice        # computed effective KV heads, from 0
    read: slice            # of those, the ones the query heads read


def head_layout(p: Attention, cfg: ModelConfig, kv_repeat: int) -> Heads:
    """The rank's heads under the rules (``wq``/``wk``/``wv`` columns and
    ``wo`` rows over ``model``).

    Rank ``r`` of ``n`` computes query heads ``[r Hq/n, (r+1) Hq/n)`` (the
    padded ones land on the last ranks, where ``wo``'s rows are zero) and
    reads effective KV head ``j // G`` for query head ``j`` (``G = Hq /
    (Hkv kv_repeat)``).  Where ``n`` divides the effective KV heads, the
    rank computes and caches its ``1/n`` of them, as ``cache_specs`` places
    the cache; otherwise it computes them all (the cache's head dim
    replicates) and reads its own.  The KV weights come from the rank's
    shard where that shard holds whole heads and exactly the original
    heads it needs; a shard that does not (qwen3-0.6b's 8 KV heads at
    ``model`` = 16: half a head a rank, and rank ``r`` needs head ``r //
    2``) is gathered over ``model`` and cut to those heads
    (``sharding.gather_over_model``): a layout decision that GSPMD takes
    too, and the only gather of the block.  Where ``n`` does not divide
    the query heads the block runs whole on every rank, its weights
    gathered."""
    dh = cfg.head_dim
    qn = getattr(p, "q_norm", None)
    kn = getattr(p, "k_norm", None)
    he = cfg.n_kv_heads * kv_repeat
    tp = sharding.tp_of(p.wq)
    if tp is None:
        return Heads(None, p.wq, p.wk, p.wv, p.wo, qn, kn, slice(0, he),
                     slice(0, he))
    n, r = tp.size, tp.index

    def whole(w, partial=True):
        t = sharding.tp_of(w)
        return sharding.gather_over_model(w, partial) if t.sharded else w

    hq = p.wo.shape[0] * (n if tp.sharded else 1) // dh
    if not tp.sharded or hq % n:
        return Heads(None, *(whole(w, False) for w in (p.wq, p.wk, p.wv,
                                                        p.wo)),
                     qn, kn, slice(0, he), slice(0, he))
    g = hq // he                                   # query heads per KV head
    hl = hq // n
    e0, e1 = r * hl // g, ((r + 1) * hl - 1) // g + 1
    if hl % (e1 - e0):
        raise NotImplementedError(
            f"{hl} query heads a rank over {e1 - e0} KV heads")
    c0, c1 = (e0, e1) if he % n == 0 else (0, he)   # computed (cached)
    o0, o1 = c0 // kv_repeat, (c1 - 1) // kv_repeat + 1   # original heads
    if cfg.n_kv_heads % n == 0:       # the shard holds heads [o0, o1)
        wk, wv = p.wk, p.wv
    else:
        cols = slice(o0 * dh, o1 * dh)
        wk, wv = whole(p.wk)[:, cols], whole(p.wv)[:, cols]
    return Heads(tp, p.wq, wk, wv, p.wo,
                 None if qn is None else sharding.tp_copy(qn, tp),
                 None if kn is None else sharding.tp_copy(kn, tp),
                 slice(c0 - o0 * kv_repeat, c1 - o0 * kv_repeat),
                 slice(e0 - c0, e1 - c0))


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 xs: Optional[torch.Tensor], positions: torch.Tensor,
                 kv_repeat: int, h: Optional[Heads] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns q ``[B,S,Hq,Dh]``, k/v ``[B,T,H_eff,Dh]`` (on a mesh the
    rank's heads, ``h`` or ``head_layout``'s): k and v from the cross
    source ``xs`` if given (and then no RoPE), else from ``x`` with RoPE
    on q and k."""
    h = head_layout(p, cfg, kv_repeat) if h is None else h
    dh = cfg.head_dim
    x = sharding.tp_copy(x, h.tp)
    src = x if xs is None else sharding.tp_copy(xs, h.tp)
    q = (x @ h.wq).unflatten(-1, (-1, dh))
    k = (src @ h.wk).unflatten(-1, (-1, dh))
    v = (src @ h.wv).unflatten(-1, (-1, dh))
    if cfg.qk_norm:
        q = layers.rmsnorm(q, h.q_norm, cfg.norm_eps)
        k = layers.rmsnorm(k, h.k_norm, cfg.norm_eps)
    if xs is None:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=2)
        v = v.repeat_interleave(kv_repeat, dim=2)
    if h.tp is not None and (h.kv_heads.start or
                             h.kv_heads.stop != k.shape[2]):
        k, v = k[:, :, h.kv_heads], v[:, :, h.kv_heads]
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
    h = head_layout(p, cfg, kv_repeat)
    if kv_override is not None:
        q = (sharding.tp_copy(x, h.tp) @ h.wq).unflatten(
            -1, (-1, cfg.head_dim))
        if cfg.qk_norm:
            q = layers.rmsnorm(q, h.q_norm, cfg.norm_eps)
        out = _sdpa(q, *(_heads(c, h) for c in kv_override), None)
        return sharding.tp_reduce(out.to(x.dtype) @ h.wo, h.tp), None
    q, k, v = _project_qkv(p, cfg, x, xs, positions, kv_repeat, h)
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
        out = _sdpa(q, _dequant(_heads(cache.k, h), _heads(cache.k_scale, h),
                                q.dtype),
                    _dequant(_heads(cache.v, h), _heads(cache.v_scale, h),
                             q.dtype), mask)
    else:
        # --- full sequence: the flash kernel, [B,H,S,D] views -------------
        # no mask at all for cross or non-causal attention, window included
        masked = cfg.causal and not cross
        kr, vr = _heads(k, h), _heads(v, h)
        o = ops.flash_attention(q.transpose(1, 2), kr.transpose(1, 2),
                                vr.transpose(1, 2), causal=masked,
                                window=cfg.sliding_window if masked else 0)
        out = o.transpose(1, 2).reshape(b, s, -1)
        if return_cache:
            new_cache = KVCache(k=k, v=v, pos=positions.to(torch.int32)
                                .reshape(-1).expand(k.shape[1]).clone())
    y = out.to(x.dtype) @ h.wo
    return sharding.tp_reduce(y, h.tp), new_cache


def _heads(t: Optional[torch.Tensor], h: Heads) -> Optional[torch.Tensor]:
    """The heads of ``t [B, S, H, .]`` that the rank's query heads read:
    all of them unless the rank computes more KV heads than it reads."""
    if t is None or h.tp is None or (h.read.start == 0 and
                                     h.read.stop == t.shape[2]):
        return t
    return t[:, :, h.read]
