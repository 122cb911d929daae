"""Architecture registry of the port: ``--arch <id>`` ids -> ModelConfig.

Only the dense rmsnorm/SwiGLU configs the port runs are registered here.
"""
from .base import ModelConfig, smoke_config

from .qwen1_5_0_5b import CONFIG as _qwen15
from .qwen2_0_5b import CONFIG as _qwen2
from .qwen3_1_7b import CONFIG as _qwen3

ARCHS = {
    "qwen1.5-0.5b": _qwen15,
    "qwen2-0.5b": _qwen2,
    "qwen3-1.7b": _qwen3,
}


def get_config(arch: str) -> ModelConfig:
    cfg = ARCHS.get(arch)
    if cfg is None:
        raise KeyError(f"unknown arch '{arch}'; have {sorted(ARCHS)}")
    return cfg


__all__ = ["ModelConfig", "ARCHS", "get_config", "smoke_config"]
