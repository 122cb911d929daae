"""qwen3-1.7b [hf:Qwen/Qwen3 family] — dense, GQA kv=8, qk-norm, d_head=128."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=6144, vocab_size=151936,
    qkv_bias=False, qk_norm=True, mlp_gated=True, activation="silu",
    norm="rmsnorm", rope_theta=1_000_000.0, tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B; hf",
)
