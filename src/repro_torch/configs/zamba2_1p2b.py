"""zamba2-1.2b [hybrid]: 38L d_model=2048, Mamba2 backbone (state=64)
with a shared attention block (32H, kv=32, d_ff=8192) applied every 6th
layer [arXiv:2411.15242].

Structure: 6 groups of (6 mamba2 layers + shared attn block) + 2
trailing mamba2 layers = 38 mamba2 layers, ONE set of attention weights
shared across its 6 applications (Zamba2's parameter-sharing trick).
The shared attention uses a 4096-token sliding window, so long_500k
decode runs with an O(1) SSM state + ring-buffer window cache."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab=32000,
    rope_theta=10_000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,     # 4096 / 64 = 64 heads, divisible by TP 16
    ssm_conv=4,
    ssm_chunk=256,
    hybrid_attn_every=6,
    sliding_window=4096,
    remat_policy="full",
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_conv=4,
    ssm_chunk=16,
    hybrid_attn_every=2,
    sliding_window=32,
)
