"""rwkv6-7b (Finch) [arXiv:2404.05892] — attention-free, data-dependent
decay, head dim 64."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=14336, vocab_size=65536,
    rwkv_head_dim=64, mlp_gated=False, activation="relu", norm="layernorm",
    source="arXiv:2404.05892; hf",
)
