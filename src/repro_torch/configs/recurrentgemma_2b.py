"""recurrentgemma-2b (Griffin) [arXiv:2402.19427] — RG-LRU + local attention,
2 recurrent blocks per 1 local-attention block (1:2), window 2048, MQA kv=1."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"), attn_window=2048,
    rglru_conv_width=4,
    mlp_gated=True, activation="gelu", norm="rmsnorm", tie_embeddings=True,
    source="arXiv:2402.19427; hf",
)
