"""Carry weights of the JAX package's ``init_params`` into the port.

``params_from_jax(cfg, tree)`` takes the JAX parameter tree with every leaf
already a numpy array (the caller does ``jax.tree.map(np.asarray, params)``;
this module imports no JAX) and returns a state dict for ``LM`` of the same
config:

  * the stacked-unit layout of ``repro.models.lm.init_params`` (each leaf of
    ``params["units"]["u0"]`` has a leading n_layers axis; dense and RWKV6
    configs have a one-layer unit and no remainder layers) is unstacked along
    axis 0 into ``blocks.<i>.<group>.<name>``, for every group of the unit:
    ``ln1``, ``attn``, ``ln2``, ``mlp`` of a dense layer, ``ln1``, ``tmix``,
    ``ln2``, ``cmix`` of an RWKV6 one;
  * every leaf crosses under its JAX key and in its JAX dtype: a LayerNorm's
    ``scale`` and ``bias`` (``ln1``, ``ln2``, ``final_norm``), an RMSNorm's
    ``scale``, a gated MLP's ``w_gate``, ``w_up``, ``w_down`` or a plain
    one's ``w_up``, ``w_down``, RWKV6's bf16 ``mu`` and weights and its fp32
    ``w0``, decay LoRA, ``u`` and ``ln_x``; ``LM.load_state_dict`` (strict)
    refuses a leaf too many or too few;
  * weights keep JAX's (in, out) orientation: the port computes ``x @ w`` as
    the JAX model does, so nothing is transposed;
  * bfloat16 crosses bit-exactly: numpy holds it as the ``bfloat16`` dtype of
    ml_dtypes, viewed here as 16-bit integers, handed to torch as int16 and
    viewed back as ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .lm import check_supported


def to_tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype and bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(cfg: ModelConfig, tree: dict) -> dict:
    """State dict of ``LM(cfg)`` from the JAX tree of numpy arrays."""
    check_supported(cfg)
    if tree.get("rem"):
        raise ValueError("a dense or RWKV6 config's JAX tree has no "
                         "remainder layers")
    sd = {"embed": to_tensor(tree["embed"])}
    for name, leaf in tree["final_norm"].items():
        sd[f"final_norm.{name}"] = to_tensor(leaf)
    if not cfg.tie_embeddings:
        sd["head"] = to_tensor(tree["head"])
    unit = tree["units"]["u0"]
    for i in range(cfg.n_layers):
        for group, leaves in unit.items():
            for name, stacked in leaves.items():
                sd[f"blocks.{i}.{group}.{name}"] = to_tensor(stacked[i])
    return sd
