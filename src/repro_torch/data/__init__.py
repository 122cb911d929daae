"""Token data of the port: ``repro.data`` copied (numpy only)."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
