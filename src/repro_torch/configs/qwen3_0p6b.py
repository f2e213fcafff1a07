"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B family].  Qwen3 uses
head_dim 128 (q/k/v projections wider than d_model) and per-head RMSNorm
on q and k.  long_500k skipped: pure full-attention architecture."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=3072,
    vocab=151936,
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    kv_repeat=2,
    remat_policy="nothing",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    qk_norm=True,
    tie_embeddings=True,
)
