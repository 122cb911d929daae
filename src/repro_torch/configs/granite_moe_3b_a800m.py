"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0 MoE family] —
40 experts, top-8, per-expert d_ff=512, GQA kv=8."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
    d_ff=512, vocab_size=49155,
    n_experts=40, top_k=8,
    qkv_bias=False, mlp_gated=True, activation="silu", norm="rmsnorm",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
