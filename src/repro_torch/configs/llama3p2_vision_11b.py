"""llama-3.2-vision-11b [vlm]: 40L total = 32 self-attention +
8 gated cross-attention layers (one every 5th), d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision].

The vision frontend is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings [B, 1601, d_model] consumed by the
cross-attention layers.  long_500k skipped: full-attention architecture.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_img_tokens=1601,
    kv_repeat=2,
    fsdp=True,
    remat_policy="full",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    name="llama3.2-vision-smoke",
    family="vlm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    cross_attn_every=2,
    n_img_tokens=17,
)
