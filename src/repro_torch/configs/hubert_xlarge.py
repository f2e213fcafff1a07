"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504 —
encoder-only transformer backbone [arXiv:2106.07447].

The modality frontend (CNN feature extractor) is a STUB per the
assignment: ``input_specs()`` provides precomputed frame embeddings
[B, T, d_model].  Training objective: frame-level CE over the 504
cluster targets (masked-prediction stub).  Encoder-only: decode_32k and
long_500k cells are skipped (no autoregressive decode step exists)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_head=80,
    d_ff=5120,
    vocab=504,
    causal=False,
    remat_policy="dots",
    shapes=("train_4k", "prefill_32k"),
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=32,
    causal=False,
)
