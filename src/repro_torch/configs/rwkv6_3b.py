"""rwkv6-3b [ssm/attention-free]: 32L d_model=2560 d_ff=8960 vocab=65536
— RWKV6 "Finch", data-dependent decay [arXiv:2404.05892].

Attention-free: O(1) decode state, so this architecture RUNS the
long_500k cell.  TP alignment: 2560/64 = 40 WKV heads padded to 48
(divisible by the 16-way model axis; zeroed output rows)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # informational: WKV heads (see rwkv_pad_heads)
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    rwkv_head_dim=64,
    rwkv_pad_heads=48,
    rwkv_lora_w=64,
    rwkv_lora_mix=32,
    remat_policy="full",
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ModelConfig(
    name="rwkv6-3b-smoke",
    family="rwkv",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    rwkv_head_dim=16,
    rwkv_lora_w=8,
    rwkv_lora_mix=8,
)
