"""Unified model configuration for all assigned architecture families.

A copy of ``repro/models/config.py``: the port keeps its own.  The port
runs the ``dense``, ``rwkv`` and ``hybrid`` families; the other fields
are kept so a configuration reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell from the assignment."""

    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    tie_embeddings: bool = False
    causal: bool = True              # False for encoder-only (hubert)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1               # every k-th layer is MoE (1 = all)
    moe_shared_expert: bool = False  # llama4-style dense shared expert
    d_ff_dense: int = 0              # FFN width of non-MoE layers (0 = d_ff)

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0               # N (state size per head)
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- RWKV6 ---
    rwkv_head_dim: int = 64
    rwkv_lora_w: int = 64            # decay LoRA rank
    rwkv_lora_mix: int = 32          # token-shift mix LoRA rank
    rwkv_pad_heads: int = 0          # pad WKV heads for even TP sharding

    # --- hybrid (zamba2): shared attention block every k ssm layers ---
    hybrid_attn_every: int = 0       # 0 = no shared attention block

    # --- VLM (llama3.2-vision): cross-attn every k-th layer ---
    cross_attn_every: int = 0        # 0 = no cross attention
    n_img_tokens: int = 1601         # stubbed vision tokens (frontend stub)

    # --- long-context handling ---
    sliding_window: int = 0          # 0 = full attention

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    # --- perf levers (§Perf hillclimbing; baseline = "ref" / 0) ---
    attn_impl: str = "ref"           # ref | chunked (flash-style, no S^2
                                     # materialisation; = Pallas kernel on TPU)
    attn_block_q: int = 1024
    attn_block_k: int = 1024
    ce_chunk: int = 0                # sequence-chunked CE loss (0 = off)
    act_constraints: bool = False    # pin canonical activation shardings
    rwkv_wkv_pins: bool = False      # pin the widened WKV activations
                                     # (independent of act_constraints)

    # --- which shape cells this arch runs (assignment skip rules) ---
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")

    # --- sharding / TP alignment ---
    fsdp: bool = False               # shard weights over the data axis too
    remat_policy: str = "nothing"    # nothing | dots | full
    pad_q_heads: int = 0             # pad query heads to this count (0 = off)
    kv_repeat: int = 1               # replicate KV heads for even TP sharding
    cache_dtype: str = "bfloat16"    # KV-cache storage dtype (int8 allowed)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    def param_count(self) -> int:
        """Rough analytic parameter count; a sanity-check helper only."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * hq * dh * 2 + d * hkv * dh * 2       # q,o + k,v
        mlp = 3 * d * f
        if self.family == "moe":
            mlp = 3 * d * f * self.n_experts + d * self.n_experts
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = attn + mlp + 2 * d
        return self.n_layers * per_layer + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, f, v = self.d_model, self.d_ff, self.vocab
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * hq * dh * 2 + d * hkv * dh * 2
        mlp = 3 * d * f * self.top_k + d * self.n_experts
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + mlp + 2 * d) + emb

    def runs_shape(self, shape_name: str) -> bool:
        return shape_name in self.shapes
