"""Architecture configuration of the port.

A copy of ``ModelConfig`` and ``smoke_config`` from ``repro.configs.base``
with the same fields and the same parameter accounting, so that
``repro_torch.configs.ModelConfig(**dataclasses.asdict(cfg))`` rebuilds any
JAX config. The port imports nothing of the JAX package and keeps this copy.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free families
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    # --- attention ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0      # partial-rotary (stablelm: 0.25)
    attn_window: int = 0            # 0 = full causal; >0 = local window
    attn_logit_softcap: float = 0.0
    # --- mlp ---
    mlp_gated: bool = True          # SwiGLU/GeGLU (3 mats) vs plain (2 mats)
    activation: str = "silu"        # silu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = False
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    # --- hybrid (recurrentgemma): per-layer block cycle ---
    block_pattern: Tuple[str, ...] = ()     # e.g. ("rglru","rglru","attn")
    rglru_conv_width: int = 4
    # --- ssm (rwkv6) ---
    rwkv_head_dim: int = 64
    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    cross_attention: bool = False
    # --- vlm ---
    cross_attn_layers: Tuple[int, ...] = ()  # decoder layers w/ image x-attn
    n_frontend_tokens: int = 0      # stubbed modality tokens (vision/audio)
    # --- bookkeeping ---
    max_seq_len: int = 1 << 20
    dtype: str = "bfloat16"
    source: str = ""                # provenance tag from the assignment table

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def group_size(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1) if self.n_heads else 0

    def block_kind(self, layer: int) -> str:
        """dense attention / rglru / rwkv per layer index."""
        if self.family == "ssm":
            return "rwkv"
        if self.block_pattern:
            return self.block_pattern[layer % len(self.block_pattern)]
        return "attn"

    # --- parameter accounting (must match models/, tested) -------------
    def attn_params(self) -> int:
        d, dh = self.d_model, self.d_head
        q = d * self.n_heads * dh
        kv = 2 * d * self.n_kv_heads * dh
        o = self.n_heads * dh * d
        bias = (self.n_heads + 2 * self.n_kv_heads) * dh if self.qkv_bias else 0
        qknorm = 2 * dh if self.qk_norm else 0
        return q + kv + o + bias + qknorm

    def mlp_params(self) -> int:
        mats = 3 if self.mlp_gated else 2
        return mats * self.d_model * self.d_ff

    def rwkv_params(self) -> int:
        """RWKV6 time-mix (r,k,v,g,o + decay LoRA) + channel-mix."""
        d = self.d_model
        tm = 5 * d * d + 6 * 32 * d + 2 * (d * 64 + 64 * d)   # lora_rank 64
        cm = d * int(3.5 * d) + int(3.5 * d) * d
        return tm + cm

    def rglru_params(self) -> int:
        """Griffin recurrent block: in/out proj (2 branches) + conv1d + gates."""
        d = self.d_model
        return 2 * d * d + d * d + self.rglru_conv_width * d + 2 * d * d

    def layer_params(self, layer: int) -> int:
        d = self.d_model
        kind = self.block_kind(layer)
        norms = 2 * d * (2 if self.norm == "layernorm" else 1)
        if kind == "rwkv":
            return self.rwkv_params() + norms
        if kind == "rglru":
            return self.rglru_params() + self.mlp_params() + norms
        p = self.attn_params() + norms
        if self.n_experts:
            p += self.n_experts * self.mlp_params() + d * self.n_experts
        else:
            p += self.mlp_params()
        if self.cross_attention:
            # enc-dec decoder layer: self-attn + cross-attn
            p += self.attn_params() + d * (2 if self.norm == "layernorm" else 1)
        # vision cross-attn layers REPLACE self-attn (gated xattn + mlp),
        # same parameter count + 1 gate scalar
        if layer in self.cross_attn_layers:
            p += 1
        return p

    def param_count(self) -> int:
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else emb
        total = emb + head + self.d_model  # final norm
        total += sum(self.layer_params(i) for i in range(self.n_layers))
        # encoder stack (whisper): same block sans cross-attn, non-causal
        enc_cfg_layers = self.n_encoder_layers
        if enc_cfg_layers:
            enc_layer = self.attn_params() + self.mlp_params() + \
                2 * self.d_model * (2 if self.norm == "layernorm" else 1)
            total += enc_cfg_layers * enc_layer + self.d_model
        return total

    def active_param_count(self) -> int:
        """MoE: only top_k experts fire per token."""
        if not self.n_experts:
            return self.param_count()
        dense = self.param_count() - self.n_layers * self.n_experts * self.mlp_params()
        return dense + self.n_layers * self.top_k * self.mlp_params()

    def kv_bytes_per_token(self, bytes_per: float = 2) -> float:
        """KV-cache bytes per token across all (attention) layers, at the
        given element width (core/precision.py policies pass theirs;
        fractional for sub-byte types)."""
        per_layer = 2 * self.n_kv_heads * self.d_head * bytes_per
        n_attn = sum(1 for i in range(self.n_layers)
                     if self.block_kind(i) == "attn")
        return per_layer * n_attn


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 2 * max(1, len(cfg.block_pattern) or 1)),
        d_model=128,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_head=32 if cfg.n_heads else 0,
        d_ff=256,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        cross_attn_layers=(1,) if cfg.cross_attn_layers else (),
        n_frontend_tokens=16 if cfg.n_frontend_tokens else 0,
        attn_window=min(cfg.attn_window, 64) if cfg.attn_window else 0,
        max_seq_len=4096,
    )
