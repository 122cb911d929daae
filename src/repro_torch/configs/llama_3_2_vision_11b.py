"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision] — image
cross-attention every 5th decoder layer; vision tower is a STUB
(input_specs provides precomputed patch embeddings)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=128256,
    cross_attn_layers=(3, 8, 13, 18, 23, 28, 33, 38),
    n_frontend_tokens=1601,
    qkv_bias=False, mlp_gated=True, activation="silu", norm="rmsnorm",
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
