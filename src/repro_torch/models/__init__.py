"""Model zoo of the port: the dense decoder, RWKV6 and Griffin of
``repro.models``."""
from . import layers, lm, recurrent
from .bridge import params_from_jax
from .lm import LM, init_cache, init_params, padded_vocab

__all__ = ["LM", "init_params", "init_cache", "padded_vocab",
           "params_from_jax", "layers", "lm", "recurrent"]
