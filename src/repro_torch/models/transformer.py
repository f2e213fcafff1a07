"""Blocks of the dense, RWKV and hybrid families: the port of
``repro/models/transformer.py:40-65, 124-150``.

The reference stacks each block's parameters along a leading layer axis
and scans over it; here a stack is an ``nn.ModuleList`` of blocks
(``stack_init``), walked by a Python loop in ``models.lm``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import attention as attn_mod
from . import layers, rwkv as rwkv_mod, ssm as ssm_mod
from .config import ModelConfig


def stack_init(n: int, make: Callable[[], torch.nn.Module]
               ) -> torch.nn.ModuleList:
    return torch.nn.ModuleList(make() for _ in range(n))


class DenseBlock(torch.nn.Module):
    """``dense_block_init``: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device, d_ff: int = 0):
        super().__init__()
        dt = layers.dtype_of(cfg.param_dtype)
        self.ln1 = layers.param((cfg.d_model,), dt, device)
        self.attn = attn_mod.Attention(cfg, device,
                                       pad_q_heads=cfg.pad_q_heads)
        self.ln2 = layers.param((cfg.d_model,), dt, device)
        self.mlp = layers.MLP(cfg.d_model, d_ff or cfg.d_ff, dt, device)

    def init(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.ln1.fill_(1)
            self.ln2.fill_(1)
        self.attn.init(gen)
        self.mlp.init(gen)


def dense_block(p: DenseBlock, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor,
                cache: Optional[attn_mod.KVCache] = None,
                cache_pos: Optional[int] = None, return_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[attn_mod.KVCache]]:
    h, new_cache = attn_mod.attention(
        p.attn, cfg, layers.rmsnorm(x, p.ln1, cfg.norm_eps), positions,
        kv_repeat=cfg.kv_repeat, cache=cache, cache_pos=cache_pos,
        return_cache=return_cache)
    x = x + h
    x = x + layers.mlp_apply(p.mlp, layers.rmsnorm(x, p.ln2, cfg.norm_eps))
    return x, new_cache


class RWKVBlock(torch.nn.Module):
    """``rwkv_block_init``: ``ln1``, ``time``, ``ln2``, ``chan``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = layers.dtype_of(cfg.param_dtype)
        self.ln1 = layers.param((cfg.d_model,), dt, device)
        self.time = rwkv_mod.TimeMix(cfg, device)
        self.ln2 = layers.param((cfg.d_model,), dt, device)
        self.chan = rwkv_mod.ChannelMix(cfg, device)

    def init(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.ln1.fill_(1)
            self.ln2.fill_(1)
        self.time.init(gen)
        self.chan.init(gen)


class MambaBlock(torch.nn.Module):
    """``mamba_block_init``: ``ln``, ``ssm`` (a Mamba2 mixer)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln = layers.param((cfg.d_model,),
                               layers.dtype_of(cfg.param_dtype), device)
        self.ssm = ssm_mod.Mamba2(cfg, device)

    def init(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.ln.fill_(1)
        self.ssm.init(gen)


def shared_attn_block(cfg: ModelConfig, device) -> DenseBlock:
    """``shared_attn_block_init``: zamba2's one attention + MLP block,
    whose weights every application along the depth shares."""
    return DenseBlock(cfg, device)
