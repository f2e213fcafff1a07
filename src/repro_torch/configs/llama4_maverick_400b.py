"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
expert d_ff=8192, vocab=202048, MoE 128 experts top-1
[hf:meta-llama/Llama-4 family].

Llama-4 Maverick interleaves dense and MoE layers (moe_every=2; dense
layers use d_ff 16384) and adds a shared expert next to the routed
top-1 expert — that reproduces the published 400B total / 17B active
split.  TP alignment: q heads padded 40 -> 48, KV replicated 8 -> 16;
128 experts shard 8-per-slice over the 16-way model axis (EP).
long_500k skipped: full-attention architecture."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    d_ff_dense=16384,
    vocab=202048,
    rope_theta=500_000.0,
    n_experts=128,
    top_k=1,
    moe_every=2,
    moe_shared_expert=True,
    capacity_factor=1.25,
    pad_q_heads=48,
    kv_repeat=2,
    fsdp=True,
    remat_policy="full",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    d_ff_dense=128,
    vocab=256,
    n_experts=4,
    top_k=1,
    moe_every=2,
    moe_shared_expert=True,
)
