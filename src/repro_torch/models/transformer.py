"""Blocks of every family: the port of ``repro/models/transformer.py``
(dense, MoE, gated cross-attention, RWKV and Mamba2 blocks).

The reference stacks each block's parameters along a leading layer axis
and scans over it; here a stack is an ``nn.ModuleList`` of blocks
(``stack_init``), walked by a Python loop in ``models.lm``.  ``remat``
wraps a block's body for training as the reference's ``_remat`` wraps
its scan body (``cfg.remat_policy``).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn_mod
from . import layers, moe as moe_mod, rwkv as rwkv_mod, ssm as ssm_mod
from .config import ModelConfig


def stack_init(n: int, make: Callable[[], torch.nn.Module]
               ) -> torch.nn.ModuleList:
    return torch.nn.ModuleList(make() for _ in range(n))


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of matrix products without batch axes (``x @ w``
    reaches autograd as ``mm``), recompute everything else: the
    counterpart of ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under ``policy``, as ``repro/models/transformer.py:22-28``:
    ``"nothing"`` saves every activation; ``"dots"`` saves the matrix
    products' outputs and recomputes the rest in the backward; any other
    policy (``"full"``) saves only the block's inputs and recomputes the
    block.  The numbers are the same under every policy; without grad
    ``fn`` runs as it is."""
    if policy == "nothing":
        return fn
    kw = {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)} \
        if policy == "dots" else {}

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


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


class MoEBlock(torch.nn.Module):
    """``moe_block_init``: ``ln1``, ``attn``, ``ln2``, ``moe`` (with the
    shared expert where ``cfg.moe_shared_expert``)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = layers.dtype_of(cfg.param_dtype)
        self.ln1 = layers.param((cfg.d_model,), dt, device)
        self.attn = attn_mod.Attention(cfg, device,
                                       pad_q_heads=cfg.pad_q_heads)
        self.ln2 = layers.param((cfg.d_model,), dt, device)
        self.moe = moe_mod.MoE(cfg, device,
                               shared_expert=cfg.moe_shared_expert)

    def init(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.ln1.fill_(1)
            self.ln2.fill_(1)
        self.attn.init(gen)
        self.moe.init(gen)


def moe_block(p: MoEBlock, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor,
              cache: Optional[attn_mod.KVCache] = None,
              cache_pos: Optional[int] = None, return_cache: bool = False
              ) -> Tuple[torch.Tensor, Optional[attn_mod.KVCache],
                         torch.Tensor]:
    h, new_cache = attn_mod.attention(
        p.attn, cfg, layers.rmsnorm(x, p.ln1, cfg.norm_eps), positions,
        kv_repeat=cfg.kv_repeat, cache=cache, cache_pos=cache_pos,
        return_cache=return_cache)
    x = x + h
    y, aux = moe_mod.moe_apply(p.moe, cfg,
                               layers.rmsnorm(x, p.ln2, cfg.norm_eps))
    return x + y, new_cache, aux


class CrossBlock(torch.nn.Module):
    """``cross_block_init``: ``ln1``, ``xattn``, ``gate_attn`` (float32
    0-d), ``ln2``, ``mlp``, ``gate_mlp``; the gates start at 0, so a new
    block passes its input through."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = layers.dtype_of(cfg.param_dtype)
        self.ln1 = layers.param((cfg.d_model,), dt, device)
        self.xattn = attn_mod.Attention(cfg, device,
                                        pad_q_heads=cfg.pad_q_heads)
        self.gate_attn = layers.param((), torch.float32, device)
        self.ln2 = layers.param((cfg.d_model,), dt, device)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dt, device)
        self.gate_mlp = layers.param((), torch.float32, device)

    def init(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.ln1.fill_(1)
            self.ln2.fill_(1)
            self.gate_attn.zero_()
            self.gate_mlp.zero_()
        self.xattn.init(gen)
        self.mlp.init(gen)


def cross_residuals(p: CrossBlock, cfg: ModelConfig, x: torch.Tensor,
                    h: torch.Tensor) -> torch.Tensor:
    """The gated residuals around the cross-attention output ``h``: the
    attention's, then the MLP's, each gate as ``tanh(gate)`` in x's
    dtype."""
    x = x + torch.tanh(p.gate_attn).to(x.dtype) * h
    m = layers.mlp_apply(p.mlp, layers.rmsnorm(x, p.ln2, cfg.norm_eps))
    return x + torch.tanh(p.gate_mlp).to(x.dtype) * m


def cross_block(p: CrossBlock, cfg: ModelConfig, x: torch.Tensor,
                img: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Gated cross-attention block (llama3.2-vision) over the source
    ``img [B, T, d]``."""
    h, _ = attn_mod.attention(
        p.xattn, cfg, layers.rmsnorm(x, p.ln1, cfg.norm_eps), positions,
        kv_repeat=cfg.kv_repeat, xs=img)
    return cross_residuals(p, cfg, x, h)


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
