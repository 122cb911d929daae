"""Architecture registry of the port: ``--arch <id>`` ids -> ModelConfig.

Every config of the JAX registry, each a copy: the rmsnorm/SwiGLU qwen
family, stablelm (LayerNorm, partial RoPE), the two MoE decoders
granite-moe-3b-a800m (40 experts, top-8, SwiGLU) and grok-1-314b (8
experts, top-2, gated GELU, attention logit softcap 30), rwkv6-7b
(attention-free RWKV6 time and channel mix, LayerNorm), whisper-tiny (an
encoder over a stub audio frontend and a decoder that cross-attends to it
in every layer), recurrentgemma-2b (Griffin: RG-LRU layers and
local-attention layers, a gated-GELU MLP), llama-3.2-vision-11b (gated
cross-attention layers over a stub image frontend in place of every 5th
self-attention layer) and, outside ``ARCHS`` as in the JAX registry, the
paper's own gpt3-175b (LayerNorm, tanh-GELU MLP, sinusoidal positions).
"""
from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable, smoke_config

from .qwen1_5_0_5b import CONFIG as _qwen15
from .qwen2_0_5b import CONFIG as _qwen2
from .stablelm_1_6b import CONFIG as _stablelm
from .qwen3_1_7b import CONFIG as _qwen3
from .granite_moe_3b_a800m import CONFIG as _granite
from .grok_1_314b import CONFIG as _grok
from .rwkv6_7b import CONFIG as _rwkv6
from .whisper_tiny import CONFIG as _whisper
from .recurrentgemma_2b import CONFIG as _rgemma
from .llama_3_2_vision_11b import CONFIG as _llamav
from .gpt3_175b import CONFIG as _gpt3

ARCHS = {
    "qwen1.5-0.5b": _qwen15,
    "qwen2-0.5b": _qwen2,
    "stablelm-1.6b": _stablelm,
    "qwen3-1.7b": _qwen3,
    "granite-moe-3b-a800m": _granite,
    "grok-1-314b": _grok,
    "rwkv6-7b": _rwkv6,
    "whisper-tiny": _whisper,
    "recurrentgemma-2b": _rgemma,
    "llama-3.2-vision-11b": _llamav,
}

# the paper's own model: selectable, but not one of the assigned archs
EXTRA_ARCHS = {"gpt3-175b": _gpt3}


def get_config(arch: str) -> ModelConfig:
    cfg = ARCHS.get(arch) or EXTRA_ARCHS.get(arch)
    if cfg is None:
        raise KeyError(f"unknown arch '{arch}'; have "
                       f"{sorted(ARCHS) + sorted(EXTRA_ARCHS)}")
    return cfg


def dryrun_cells():
    """Every (arch, shape name) pair of the dry run that
    ``shape_applicable`` admits."""
    return [(arch, shape.name) for arch, cfg in ARCHS.items() for shape in SHAPES.values()
            if shape_applicable(cfg, shape)]


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "EXTRA_ARCHS", "get_config",
           "shape_applicable", "smoke_config", "dryrun_cells"]
