"""Carry weights of the JAX package's ``init_params`` into the port.

``params_from_jax(cfg, tree)`` takes the JAX parameter tree with every leaf
already a numpy array (the caller does ``jax.tree.map(np.asarray, params)``;
this module imports no JAX) and returns a state dict for ``LM`` of the same
config:

  * the stacked-unit layout of ``repro.models.lm.init_params`` is unstacked
    into the port's layer order: leaf ``params["units"]["u<j>"]`` has a
    leading n_units axis, whose entry r is layer ``r * len(unit) + j``, and
    ``params["rem"]["r<j>"]`` is layer ``n_units * len(unit) + j`` (dense
    and RWKV6 configs have a one-layer unit and no remainder; Griffin's unit
    is (rglru, rglru, attn) with a remainder of two rglru layers). Each
    lands in ``blocks.<i>.<group>.<name>``, for every group of the layer:
    ``ln1``, ``attn``, ``ln2``, ``mlp`` of an attention layer (``moe`` in
    place of ``mlp`` in an MoE model), the same and ``lnx``, ``xattn`` of an
    encoder-decoder's decoder layer, ``ln1``, ``xattn``, ``ln2``, ``mlp`` of
    a vision cross layer, whose ``xgate`` is a leaf of the layer itself
    (``blocks.<i>.xgate``), ``ln1``, ``rec``, ``ln2``, ``mlp`` of an RG-LRU
    one, ``ln1``, ``tmix``, ``ln2``, ``cmix`` of an RWKV6 one;
  * an encoder-decoder's encoder: ``params["enc"]["layers"]`` stacked with
    the encoder layer on axis 0, each entry landing in
    ``enc.layers.<i>.<group>.<name>`` (``ln1``, ``attn``, ``ln2``, ``mlp``),
    and ``params["enc"]["final_norm"]`` in ``enc.final_norm.<name>``;
  * every leaf crosses under its JAX key and in its JAX dtype: a LayerNorm's
    ``scale`` and ``bias`` (``ln1``, ``ln2``, ``final_norm``), an RMSNorm's
    ``scale``, a gated MLP's ``w_gate``, ``w_up``, ``w_down`` or a plain
    one's ``w_up``, ``w_down``, the MoE layer's fp32 ``router`` (d, E) and
    its experts' bf16 ``w_up``, ``w_gate`` (E, d, f) and ``w_down`` (E, f,
    d), each under the stacked-unit axis like every leaf, RWKV6's bf16
    ``mu`` and weights and its fp32 ``w0``, decay LoRA, ``u`` and ``ln_x``,
    the RG-LRU block's bf16 ``w_gate``, ``w_in``, ``conv_w``, ``conv_b``,
    ``w_out`` and fp32 ``w_a``, ``w_x``, ``lam``; ``LM.load_state_dict``
    (strict) refuses a leaf too many or too few;
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
from .lm import check_supported, unit_structure


def to_tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype and bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(cfg: ModelConfig, tree: dict) -> dict:
    """State dict of ``LM(cfg)`` from the JAX tree of numpy arrays."""
    check_supported(cfg)
    unit, n_units, rem = unit_structure(cfg)
    if set(tree["units"]) != {f"u{j}" for j in range(len(unit))} or \
            set(tree.get("rem") or {}) != {f"r{j}" for j in range(len(rem))}:
        raise ValueError(f"the JAX tree's units {sorted(tree['units'])} and remainder "
                         f"{sorted(tree.get('rem') or {})} are not those of {cfg.name}: "
                         f"unit {unit} x {n_units}, remainder {rem}")
    sd = {"embed": to_tensor(tree["embed"])}
    for name, leaf in tree["final_norm"].items():
        sd[f"final_norm.{name}"] = to_tensor(leaf)
    if not cfg.tie_embeddings:
        sd["head"] = to_tensor(tree["head"])
    layers = [(r * len(unit) + j, tree["units"][f"u{j}"], r)
              for r in range(n_units) for j in range(len(unit))]
    layers += [(n_units * len(unit) + j, tree["rem"][f"r{j}"], None) for j in range(len(rem))]
    layers = [(f"blocks.{i}", groups, r) for i, groups, r in layers]
    if cfg.n_encoder_layers:
        enc = tree["enc"]
        layers += [(f"enc.layers.{i}", enc["layers"], i) for i in range(cfg.n_encoder_layers)]
        sd.update({f"enc.final_norm.{name}": to_tensor(leaf)
                   for name, leaf in enc["final_norm"].items()})
    for prefix, groups, r in layers:
        for group, leaves in groups.items():
            # a group is a dict of leaves, or a leaf of its own (xgate)
            items = leaves.items() if isinstance(leaves, dict) else [(None, leaves)]
            for name, leaf in items:
                key = f"{prefix}.{group}" if name is None else f"{prefix}.{group}.{name}"
                sd[key] = to_tensor(leaf if r is None else leaf[r])
    return sd
