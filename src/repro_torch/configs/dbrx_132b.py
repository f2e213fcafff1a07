"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4 (fine-grained)
[hf:databricks/dbrx-base].  Every layer is MoE.  TP alignment: 48 heads
/ 16 OK; KV replicated 8 -> 16; 16 experts = 1 per model slice (EP).
long_500k skipped: full-attention architecture."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10752,
    vocab=100352,
    rope_theta=500_000.0,
    n_experts=16,
    top_k=4,
    moe_every=1,
    capacity_factor=1.25,
    kv_repeat=2,
    fsdp=True,
    remat_policy="full",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    name="dbrx-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    vocab=256,
    n_experts=4,
    top_k=2,
    moe_every=1,
)
