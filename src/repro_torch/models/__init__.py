"""Model zoo of the port: the dense decoder, RWKV6 and Griffin of
``repro.models``, and the dry run's abstract shapes of a model
(``abstract_params``, ``abstract_cache``, ``input_specs``): each a dict of
name -> (shape, dtype), made on the meta device, nothing allocated."""
import torch

from ..configs.base import ModelConfig, ShapeConfig
from . import layers, lm, recurrent
from .bridge import params_from_jax, params_to_jax
from .lm import (LM, check_trainable, greedy_token, init_cache, init_params, loss_fn,
                 needs_frontend, padded_vocab)


def abstract_params(cfg: ModelConfig) -> dict:
    """{port leaf name: (shape, dtype)} of the model's parameters, from an
    ``LM`` on the meta device."""
    return {n: (tuple(p.shape), p.dtype) for n, p in LM(cfg, None, "meta").named_parameters()}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """{cache entry: (shape, dtype)} of ``init_cache(cfg, batch, max_len)``."""
    return {n: (tuple(t.shape), t.dtype)
            for n, t in init_cache(cfg, batch, max_len, "meta").items()}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """{input name: (shape, dtype)} of a dry-run cell, as the JAX
    ``input_specs`` gives them: train {tokens, targets, mask}, prefill
    {tokens}, decode {token}, and a bf16 frontend (B, n_frontend_tokens, d)
    where the model reads one (``needs_frontend``), never at decode."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        spec = {"tokens": ((B, S), torch.int32), "targets": ((B, S), torch.int32),
                "mask": ((B, S), torch.float32)}
    elif shape.kind == "prefill":
        spec = {"tokens": ((B, S), torch.int32)}
    else:
        spec = {"token": ((B,), torch.int32)}
    if needs_frontend(cfg) and shape.kind != "decode":
        spec["frontend"] = ((B, max(cfg.n_frontend_tokens, 1), cfg.d_model), torch.bfloat16)
    return spec


__all__ = ["LM", "init_params", "init_cache", "padded_vocab", "loss_fn", "greedy_token",
           "check_trainable", "needs_frontend", "params_from_jax", "params_to_jax", "layers",
           "lm", "recurrent", "abstract_params", "abstract_cache", "input_specs"]
