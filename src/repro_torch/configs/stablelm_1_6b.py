"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b] — dense MHA, LayerNorm,
partial rotary (25%)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=5632, vocab_size=100352,
    qkv_bias=False, mlp_gated=True, activation="silu", norm="layernorm",
    rope_fraction=0.25, rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
