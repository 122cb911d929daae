"""GPT-3 175B [arXiv:2005.14165] — the paper's own evaluation model
(96 layers, d_model 12288, 96 heads). Used by the simulator benchmarks."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gpt3-175b", family="dense",
    n_layers=96, d_model=12288, n_heads=96, n_kv_heads=96, d_head=128,
    d_ff=49152, vocab_size=50257,
    qkv_bias=True, mlp_gated=False, activation="gelu", norm="layernorm",
    rope_fraction=0.0,
    source="arXiv:2005.14165 (paper Sec. IV setup)",
)
