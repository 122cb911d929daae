"""Model zoo of the port: the dense decoder, RWKV6 and Griffin of
``repro.models``."""
from . import layers, lm, recurrent
from .bridge import params_from_jax, params_to_jax
from .lm import (LM, check_trainable, init_cache, init_params, loss_fn, needs_frontend,
                 padded_vocab)

__all__ = ["LM", "init_params", "init_cache", "padded_vocab", "loss_fn",
           "check_trainable", "needs_frontend", "params_from_jax", "params_to_jax", "layers",
           "lm", "recurrent"]
