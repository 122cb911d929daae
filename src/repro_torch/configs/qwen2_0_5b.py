"""qwen2-0.5b [arXiv:2407.10671] — dense, GQA kv=2, QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, mlp_gated=True, activation="silu", norm="rmsnorm",
    rope_theta=1_000_000.0, tie_embeddings=True,
    source="arXiv:2407.10671; hf",
)
