"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Llama-architecture GQA [arXiv:2403.04652].  TP alignment on the 16-way
model axis: query heads padded 56 -> 64 (zeroed o-proj rows, exact
no-ops), KV heads replicated 8 -> 16.  Decode KV cache stored int8 (the
bf16 cache would not fit 16 GB/chip HBM at decode_32k; see DESIGN.md).
long_500k skipped: pure full-attention architecture.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5_000_000.0,
    pad_q_heads=64,
    kv_repeat=2,
    cache_dtype="int8",
    fsdp=True,
    remat_policy="full",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    name="yi-34b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=128,
    vocab=256,
    pad_q_heads=0,
    kv_repeat=1,
)
