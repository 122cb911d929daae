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

``params_to_jax(cfg, state_dict)`` is the inverse: it restacks the port's
layers into the JAX tree (units on axis 0, the ``rem`` remainder, the
encoder's layers), every leaf a numpy array under its JAX key and in its
JAX dtype. numpy has no bfloat16 of its own (the card's host has no
ml_dtypes), so a bf16 leaf goes out as its raw 2-byte values, numpy's void
dtype ``V2`` (``BF16_RAW``), which is also how ``np.savez`` stores the
JAX package's ml_dtypes bfloat16; ``to_tensor`` reads ``V2`` back as
bf16. ``decayed_leaves`` names the parameters whose JAX leaf has
``ndim >= 2``, the leaves the JAX AdamW decays (``ROADMAP.md`` C14).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .lm import check_supported, unit_structure


#: numpy's form of a bf16 array here: its raw 2-byte values
BF16_RAW = np.dtype("V2")


def is_bf16(a: np.ndarray) -> bool:
    """An ml_dtypes bfloat16 array, or raw bf16 values (``BF16_RAW``)."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor as a numpy array of the same bits; bf16 as
    ``BF16_RAW``. The copy shares no memory with `t`."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RAW)
    return t.numpy()


def to_tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype and bits (a tensor
    passes through)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not a.flags.c_contiguous:     # np.ascontiguousarray would make a 0-dim array 1-dim
        a = a.copy(order="C")
    if is_bf16(a):
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


def _layer_prefixes(cfg: ModelConfig):
    """(JAX place, port prefix, stacked-unit row or None) of every layer:
    ("units", "u<j>") at row r, ("rem", "r<j>"), and ("enc", "layers") at
    row i for an encoder layer."""
    unit, n_units, rem = unit_structure(cfg)
    out = [(("units", f"u{j}"), f"blocks.{r * len(unit) + j}", r)
           for r in range(n_units) for j in range(len(unit))]
    out += [(("rem", f"r{j}"), f"blocks.{n_units * len(unit) + j}", None)
            for j in range(len(rem))]
    out += [(("enc", "layers"), f"enc.layers.{i}", i) for i in range(cfg.n_encoder_layers)]
    return out


def params_to_jax(cfg: ModelConfig, state_dict: dict) -> dict:
    """The JAX parameter tree of numpy arrays (bf16 as ``BF16_RAW``) from a
    state dict of ``LM(cfg)``: the inverse of ``params_from_jax``."""
    check_supported(cfg)
    sd = dict(state_dict)
    tree = {"embed": to_numpy(sd.pop("embed")),
            "final_norm": {}, "units": {}, "rem": {}}
    if cfg.n_encoder_layers:
        tree["enc"] = {"layers": {}, "final_norm": {}}
    rows = {}   # (place, JAX path of the leaf) -> {row: tensor}
    for place, prefix, r in _layer_prefixes(cfg):
        for key in [k for k in sd if k.startswith(prefix + ".")]:
            path = tuple(key[len(prefix) + 1:].split("."))
            t = sd.pop(key)
            if r is None:
                node = tree[place[0]].setdefault(place[1], {})
                for part in path[:-1]:
                    node = node.setdefault(part, {})
                node[path[-1]] = to_numpy(t)
            else:
                rows.setdefault((place, path), {})[r] = t
    for (place, path), by_row in rows.items():
        node = tree[place[0]].setdefault(place[1], {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = to_numpy(torch.stack([by_row[r] for r in sorted(by_row)]))
    for key in [k for k in sd if k.startswith("final_norm.")]:
        tree["final_norm"][key.split(".", 1)[1]] = to_numpy(sd.pop(key))
    for key in [k for k in sd if k.startswith("enc.final_norm.")]:
        tree["enc"]["final_norm"][key.rsplit(".", 1)[1]] = to_numpy(sd.pop(key))
    if not cfg.tie_embeddings:
        tree["head"] = to_numpy(sd.pop("head"))
    if sd:
        raise ValueError(f"leaves of no JAX place: {sorted(sd)}")
    return tree


def decayed_leaves(cfg: ModelConfig, params: dict) -> set:
    """The parameter names whose JAX leaf has ndim >= 2, which the JAX
    AdamW decays (``ROADMAP.md`` C14): every leaf of a layer stacked along
    a leading axis (a repeated unit's, an encoder layer's) whatever its own
    shape, else a leaf of two or more dimensions."""
    stacked = tuple(prefix + "." for _, prefix, r in _layer_prefixes(cfg) if r is not None)
    return {n for n, p in params.items() if n.startswith(stacked) or p.dim() >= 2}
