from .engine import Engine, Request
from .sampler import SamplingParams, sample, sample_per_request

__all__ = ["Engine", "Request", "SamplingParams", "sample",
           "sample_per_request"]
