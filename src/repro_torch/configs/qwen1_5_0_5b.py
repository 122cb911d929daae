"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B] — dense, MHA (GQA kv=16), QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=2816, vocab_size=151936,
    qkv_bias=True, mlp_gated=True, activation="silu", norm="rmsnorm",
    rope_theta=1_000_000.0, tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
