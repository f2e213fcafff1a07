"""The language model of the dense and RWKV families: the port of
``repro/models/lm.py``.

  dense   [attn + mlp] x L           (qwen3, llama3.2, stablelm)
  rwkv    [time-mix + channel-mix] x L   (rwkv6)

``LM`` is an ``nn.Module`` that holds its parameters (inference only:
none requires a gradient) under the reference's names, block ``i`` of
the reference's stacked ``blocks`` tree being ``blocks.i``
(``models.convert`` carries a JAX parameter tree across).  The other
families (moe, vlm, audio, hybrid) and training wait for later slices
(ROADMAP.md, queue 1) and raise ``NotImplementedError``.

Caches are stacked along a leading layer axis as in the reference
(``KVCache`` with ``k [L, B, S, H, Dh]``; ``RWKVCache`` with ``state
[L, B, H, dk, dv]``); ``decode_step`` updates them in place and returns
them.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from ..device import resolve
from . import attention as attn_mod
from . import layers, rwkv as rwkv_mod
from . import transformer as tf
from .config import ModelConfig

FAMILIES = ("dense", "rwkv")


def _check(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, "
            f"queue 1); the port runs {FAMILIES}")
    if cfg.family == "dense":
        attn_mod.check_supported(cfg)
    elif cfg.rwkv_wkv_pins or cfg.act_constraints:
        raise NotImplementedError(
            "the sharding pins are not ported yet (ROADMAP.md, queue 1)")


class LM(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _check(cfg)
        self.cfg = cfg
        dev = resolve(device)
        dt = layers.dtype_of(cfg.param_dtype)
        self.embed = layers.param((cfg.vocab, cfg.d_model), dt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = layers.param((cfg.d_model, cfg.vocab), dt, dev)
        self.ln_f = layers.param((cfg.d_model,), dt, dev)
        block = tf.DenseBlock if cfg.family == "dense" else tf.RWKVBlock
        self.blocks = tf.stack_init(cfg.n_layers, lambda: block(cfg, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> "LM":
        """Random initialisation from ``generator`` (on the model's
        device), with the reference's distributions: truncated normals
        at fan-in scale, ones for norms, zeroed padded-head rows."""
        layers.embed_init(self.embed, generator)
        if not self.cfg.tie_embeddings:
            layers.dense_init(self.lm_head, generator)
        with torch.no_grad():
            self.ln_f.fill_(1)
        for blk in self.blocks:
            blk.init(generator)
        return self

    # ------------------------------------------------------------------
    # input embedding / unembedding
    # ------------------------------------------------------------------
    def _embed(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.embed[batch["tokens"]]

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ head

    # ------------------------------------------------------------------
    # backbone (full sequence)
    # ------------------------------------------------------------------
    def _backbone(self, x: torch.Tensor, positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "dense":
            for blk in self.blocks:
                x, _ = tf.dense_block(blk, cfg, x, positions)
        else:
            for blk in self.blocks:
                h, _, _ = rwkv_mod.time_mix_forward(
                    blk.time, cfg, layers.rmsnorm(x, blk.ln1, cfg.norm_eps))
                y = x + h
                h2, _ = rwkv_mod.channel_mix_forward(
                    blk.chan, cfg, layers.rmsnorm(y, blk.ln2, cfg.norm_eps))
                x = y + h2
        return x, aux

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def cache_len(self, seq_len: int) -> int:
        return seq_len

    def init_caches(self, batch: int, seq_len: int):
        """Zeroed decode caches sized for a context of ``seq_len``,
        stacked along a leading layer axis."""
        cfg, dev, L = self.cfg, self.device, self.cfg.n_layers
        if cfg.family == "dense":
            one = attn_mod.init_cache(cfg, batch, self.cache_len(seq_len),
                                      kv_repeat=cfg.kv_repeat,
                                      cache_dtype=cfg.cache_dtype,
                                      device=dev)
            return attn_mod.KVCache(*(a.expand(L, *a.shape).clone()
                                      for a in one))
        one = rwkv_mod.init_rwkv_cache(cfg, batch, device=dev)
        return rwkv_mod.RWKVCache(*(a.expand(L, *a.shape).clone()
                                    for a in one))

    # ------------------------------------------------------------------
    # decode step (one new token against an existing cache)
    # ------------------------------------------------------------------
    def decode_step(self, caches, token: torch.Tensor,
                    pos: Union[int, torch.Tensor]):
        """token ``[B, 1]`` int, pos an int (or a 0-d tensor) -> (logits
        ``[B, V]``, caches).  The caches are updated in place."""
        cfg = self.cfg
        pos = int(pos)
        x = self.embed[token]
        positions = torch.tensor([pos], dtype=torch.int32, device=x.device)
        if cfg.family == "dense":
            slot = self._slot(pos, caches.k.shape[2])
            for i, blk in enumerate(self.blocks):
                layer = attn_mod.KVCache(caches.k[i], caches.v[i],
                                         caches.pos[i])
                x, _ = tf.dense_block(blk, cfg, x, positions, cache=layer,
                                      cache_pos=slot)
        else:
            for i, blk in enumerate(self.blocks):
                h, state, last_t = rwkv_mod.time_mix_decode(
                    blk.time, cfg, layers.rmsnorm(x, blk.ln1, cfg.norm_eps),
                    caches.shift_t[i], caches.state[i])
                y = x + h
                xn = layers.rmsnorm(y, blk.ln2, cfg.norm_eps)
                h2, last_c = rwkv_mod.channel_mix_forward(
                    blk.chan, cfg, xn, cache_shift=caches.shift_c[i])
                caches.shift_t[i].copy_(last_t)
                caches.shift_c[i].copy_(last_c)
                caches.state[i].copy_(state)
                x = y + h2
        x = layers.rmsnorm(x, self.ln_f, cfg.norm_eps)
        logits = self._unembed(x)[:, 0, :]
        return logits, caches

    def _slot(self, pos: int, cache_size: int) -> int:
        return pos

    # ------------------------------------------------------------------
    # prefill: full-sequence forward that also fills decode caches
    # ------------------------------------------------------------------
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """Returns (last-token logits ``[B, V]``, caches ready for
        decode).  The dense family only, as in the reference."""
        cfg = self.cfg
        if cfg.family != "dense":
            raise NotImplementedError(
                f"prefill for family {cfg.family} lives in "
                f"examples/serve_batch")
        x = self._embed(batch)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)
        ks, vs, ps = [], [], []
        for blk in self.blocks:
            x, nc = tf.dense_block(blk, cfg, x, positions, return_cache=True)
            ks.append(nc.k)
            vs.append(nc.v)
            ps.append(nc.pos)
        caches = attn_mod.KVCache(torch.stack(ks), torch.stack(vs),
                                  torch.stack(ps))
        x = layers.rmsnorm(x, self.ln_f, cfg.norm_eps)
        logits = self._unembed(x[:, -1:, :])[:, 0, :]
        return logits, caches
