"""stablelm-1.6b [dense]: 24L d_model=2048 32H (GQA kv=32 = MHA)
d_ff=5632 vocab=100352 [hf:stabilityai/stablelm-2-1_6b].
long_500k skipped: pure full-attention architecture."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=5632,
    vocab=100352,
    rope_theta=10_000.0,
    remat_policy="nothing",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    name="stablelm-1.6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=256,
)
