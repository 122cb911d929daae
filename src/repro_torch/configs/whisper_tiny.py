"""whisper-tiny [arXiv:2212.04356] — enc-dec transformer backbone; conv audio
frontend is a STUB (input_specs provides precomputed frame embeddings)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_head=64,
    d_ff=1536, vocab_size=51865,
    n_encoder_layers=4, cross_attention=True,
    qkv_bias=True, mlp_gated=False, activation="gelu", norm="layernorm",
    rope_fraction=0.0,            # learned positions; backbone uses none here
    n_frontend_tokens=1500,
    source="arXiv:2212.04356; unverified",
)
