"""Step functions of the serving path: the port of
``repro/launch/steps.py:61,78`` (``make_prefill_step``,
``make_serve_step``).

The reference builds an ``LM`` from a config and passes the parameters to
each call; here ``LM`` holds its parameters, so each maker takes the
model.  ``make_train_step`` waits for training (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch

from ..models import layers
from ..models.lm import LM


def make_prefill_step(lm: LM):
    """Inference forward over the full sequence -> last-token logits
    ``[B, V]``, for every family: the batch holds ``tokens``, and the
    vlm family's ``img [B, T, d]`` or the audio family's ``frames [B, S,
    d]`` in place of tokens."""
    cfg = lm.cfg

    @torch.inference_mode()
    def prefill_step(batch):
        x = lm._embed(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = lm._backbone(x, positions, batch)
        x = layers.rmsnorm(x, lm.ln_f, cfg.norm_eps)
        return lm._unembed(x[:, -1:, :])[:, 0, :]

    return prefill_step


def make_serve_step(lm: LM):
    """One decode step: (caches, token, pos) -> (logits, caches), the
    caches those of ``lm.init_caches`` (a stacked ``KVCache``, bf16,
    float32 or int8 with its scales, of the dense and moe families; the
    vlm family's dict with its cross caches; an ``RWKVCache``; the hybrid
    family's dict), updated in place.  The audio encoder does not
    decode."""

    @torch.inference_mode()
    def serve_step(caches, token, pos):
        return lm.decode_step(caches, token, pos)

    return serve_step
