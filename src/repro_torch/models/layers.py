"""Model primitives of the port: ``repro.models.layers`` but the mesh-only
expert padding and sharding of the MoE layer.

Conventions, as in the JAX package:
  * parameters live in ``nn.ParameterDict``s whose keys are the JAX tree's
    keys; ``*_init`` builds one, the matching apply function reads it;
  * weights keep JAX's (in, out) orientation, so a projection is ``x @ w``;
  * activations bf16, reductions and normalisers fp32.

The norms, the MLP activations (the experts' too) and attention go through
the kernel ops, which launch the Hopper kernels for CUDA tensors and run
their plain versions for CPU tensors. Projections, the router and the
experts' products stay ``torch.matmul`` / ``torch.bmm``, and the MoE
dispatch and combine plain tensor ops, as the JAX package leaves them to
XLA.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention as _flash_op
from ..kernels.flash_attention.ref import NEG_INF, attention_ref
from ..kernels.gelu.ops import gelu, gelu_mul, silu_mul
from ..kernels.rmsnorm.ops import layernorm, rmsnorm

Params = nn.ParameterDict


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _init(gen: Optional[torch.Generator], shape, scale: float = 0.02,
          device=None, dtype: torch.dtype = torch.bfloat16) -> nn.Parameter:
    """N(0, scale^2) drawn in fp32, stored as `dtype`, bf16 by default (as
    ``layers._init``). With no generator (the meta device) only the shape is
    made."""
    if gen is None:
        return _param(torch.empty(shape, dtype=dtype, device=device))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return _param(x.mul_(scale).to(dtype))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, any leading shape, through the kernel op."""
    shape = x.shape
    return rmsnorm(x.reshape(-1, shape[-1]), scale, eps=eps).reshape(shape)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, any leading shape, through the kernel op."""
    shape = x.shape
    return layernorm(x.reshape(-1, shape[-1]), scale, bias, eps=eps).reshape(shape)


def norm_init(cfg: ModelConfig, device=None) -> Params:
    """fp32 ``scale`` (ones), and for LayerNorm an fp32 ``bias`` (zeros)."""
    p = Params({"scale": _param(torch.ones(cfg.d_model, dtype=torch.float32,
                                           device=device))})
    if cfg.norm == "layernorm":
        p["bias"] = _param(torch.zeros(cfg.d_model, dtype=torch.float32,
                                       device=device))
    return p


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


# ---------------------------------------------------------------------------
# rotary position embedding (partial-fraction aware)
# ---------------------------------------------------------------------------

def rope_frequencies(cfg: ModelConfig, device=None) -> torch.Tensor:
    rot = int(cfg.d_head * cfg.rope_fraction) // 2 * 2
    if rot == 0:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (cfg.rope_theta ** exps)


def rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """(cos, sin) of shape (..., seq, 1, rot), fp32, each angle repeated for
    the two members of its rotated pair. Built once per model step and
    shared by every layer."""
    inv = rope_frequencies(cfg, positions.device)
    ang = positions[..., :, None].float() * inv           # (.., seq, rot/2)
    ang = ang.repeat_interleave(2, dim=-1)[..., :, None, :]  # broadcast over heads
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotate the interleaved pairs (x1, x2) of the first `rot` dims of
    x (..., seq, heads, d_head): (x1 cos - x2 sin, x2 cos + x1 sin) in fp32,
    rounded to x's dtype; dims past `rot` pass through."""
    cos, sin = tables
    rot = cos.shape[-1]
    if rot == 0:
        return x
    xr = x[..., :rot]
    pairs = xr.unflatten(-1, (rot // 2, 2))
    swapped = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)
    out = (xr * cos + swapped * sin).to(x.dtype)
    return out if rot == x.shape[-1] else torch.cat([out, x[..., rot:]], dim=-1)


def apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: (..., seq)."""
    return rotate(x, rope_tables(cfg, positions))


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """fp32 sinusoidal embeddings (..., d) of integer positions (...): sin at
    the even dims, cos at the odd ones, of ``pos / 10000^(2i/d)``. The JAX
    ``sinusoidal_positions(seq, d, offset)`` is this at positions
    offset..offset+seq-1, and its decode step builds the same rows at each
    sequence's own position."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)
    ang = positions[..., None].float() / torch.pow(10000.0, dim / d)
    out = torch.empty(positions.shape + (d,), dtype=torch.float32,
                      device=positions.device)
    out[..., 0::2] = torch.sin(ang)
    out[..., 1::2] = torch.cos(ang[..., : d // 2])
    return out


# ---------------------------------------------------------------------------
# attention in the model's (B, S, H, D) layout
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D).

    The kernel op takes (B, H, S, D); the transposes are strided views, not
    copies, and the result is a view of a (B, Sq, Hq, D) buffer."""
    o = _flash_op(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=causal, window=window, softcap=logit_softcap)
    return o.transpose(1, 2)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        logit_softcap: float = 0.0) -> torch.Tensor:
    """Naive full-score attention in the model's layout (test oracle)."""
    o = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=causal, window=window, softcap=logit_softcap)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# attention block: GQA + qk-norm + rope + bias
# ---------------------------------------------------------------------------

def attn_init(cfg: ModelConfig, gen: Optional[torch.Generator], device=None) -> Params:
    d, dh = cfg.d_model, cfg.d_head
    p = Params({
        "wq": _init(gen, (d, cfg.n_heads * dh), device=device),
        "wk": _init(gen, (d, cfg.n_kv_heads * dh), device=device),
        "wv": _init(gen, (d, cfg.n_kv_heads * dh), device=device),
        "wo": _init(gen, (cfg.n_heads * dh, d),
                    scale=0.02 / math.sqrt(2 * cfg.n_layers), device=device),
    })
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = _param(torch.zeros(n * dh, dtype=torch.bfloat16, device=device))
    if cfg.qk_norm:
        p["q_norm"] = _param(torch.ones(dh, dtype=torch.float32, device=device))
        p["k_norm"] = _param(torch.ones(dh, dtype=torch.float32, device=device))
    return p


def attn_q(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """q (B, S, Hq, dh) before RoPE: the projection, its bias and its qk-norm."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    return rms_norm(q, p["q_norm"]) if cfg.qk_norm else q


def attn_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, rope=None,
             kv_src: Optional[torch.Tensor] = None):
    """q (B, S, Hq, dh) and k, v (B, Sk, Hkv, dh). Self-attention: k and v
    from x (Sk = S), q and k rotated by rope, ``rope_tables(cfg,
    positions)`` of the step (the JAX function takes the positions and
    builds the tables in every layer). Cross-attention: k and v from
    `kv_src` (B, Sk, d), and no RoPE, as the JAX function applies none when
    given a ``kv_src``; qk-norm applies either way."""
    src = x if kv_src is None else kv_src
    B, Sk, _ = src.shape
    k = src @ p["wk"]
    v = src @ p["wv"]
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    k = k.reshape(B, Sk, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, Sk, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    q = attn_q(cfg, p, x)
    if kv_src is not None or rope is None:
        return q, k, v
    return rotate(q, rope), rotate(k, rope), v


def attn_out(p: Params, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP: gated SiLU, gated tanh-GELU or plain tanh-GELU
# ---------------------------------------------------------------------------

def mlp_init(cfg: ModelConfig, gen: Optional[torch.Generator], device=None) -> Params:
    """``w_up`` and ``w_down``, and ``w_gate`` for a gated MLP only."""
    d, f = cfg.d_model, cfg.d_ff
    p = Params({
        "w_up": _init(gen, (d, f), device=device),
        "w_down": _init(gen, (f, d), scale=0.02 / math.sqrt(2 * cfg.n_layers),
                        device=device),
    })
    if cfg.mlp_gated:
        p["w_gate"] = _init(gen, (d, f), device=device)
    return p


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gated: SwiGLU ``silu(x @ w_gate) * (x @ w_up)`` through the fused gate
    op, or with ``activation == "gelu"`` (recurrentgemma) the gated GELU
    ``gelu(x @ w_gate) * (x @ w_up)`` through the gated-GELU op. Plain:
    ``gelu(x @ w_up)`` through the tanh-GELU op (the JAX ``_act`` arm of
    gpt3; the port runs no other plain activation). The ops compute in fp32
    and round once to bf16, where the JAX model computes the activation and
    the product on bf16 tensors; model-level tolerances allow for that."""
    if cfg.mlp_gated:
        gated = gelu_mul if cfg.activation == "gelu" else silu_mul
        h = gated(x @ p["w_gate"], x @ p["w_up"])
    else:
        h = gelu(x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE: top-k routing with capacity and drop (Switch/GShard)
# ---------------------------------------------------------------------------

def moe_init(cfg: ModelConfig, gen: Optional[torch.Generator], device=None) -> Params:
    """An fp32 ``router`` (d, E) and the experts' bf16 ``w_up`` (E, d, f),
    ``w_down`` (E, f, d) and, gated, ``w_gate`` (E, d, f)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = Params({
        "router": _init(gen, (d, E), device=device, dtype=torch.float32),
        "w_up": _init(gen, (E, d, f), device=device),
        "w_down": _init(gen, (E, f, d), scale=0.02 / math.sqrt(2 * cfg.n_layers),
                        device=device),
    })
    if cfg.mlp_gated:
        p["w_gate"] = _init(gen, (E, d, f), device=device)
    return p


@contextlib.contextmanager
def _ieee_fp32():
    """fp32 products in IEEE fp32 (no TF32) whatever the process has set:
    the router's logits decide which experts run, as the JAX model's fp32
    dot decides them."""
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def moe_route(cfg: ModelConfig, p: Params, xt: torch.Tensor):
    """Routing of tokens xt (T, d): (probs (T, E) fp32, the softmax of the
    fp32 router logits; gate (T, k) fp32, the top-k probabilities, largest
    first, over their sum; idx (T, k) int64, their experts)."""
    with _ieee_fp32():
        logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), idx


def moe_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
              capacity_factor: float = 1.25, with_aux: bool = True):
    """Top-k routed experts with a capacity and drop, as the JAX
    ``moe_apply``: x (B, S, d) -> (y (B, S, d), the Switch aux loss ``E *
    sum(mean probs * routed share)``, or None where `with_aux` is False, as
    serving calls it). The aux reaches the router only through the
    probabilities: the routed share is a count.

    Every (token, choice) takes the next slot of its expert's buffer of
    ``capacity`` rows, in the flat (token, choice) order; one past the
    capacity is dropped and adds nothing to its token. Every token of x
    routes and takes capacity, a padded wave's pads and a decode step's idle
    slots too (ROADMAP.md, C10). Each expert runs over its whole buffer.
    Fixed shapes and no host sync: the dropped rows are written to one
    overflow row past the E buffers, which is sliced off. The k outputs of a
    token are weighted by their gates and summed in fp32, then rounded to
    bf16 once (the JAX model rounds each term and adds them in bf16)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    probs, gate, idx = moe_route(cfg, p, xt)
    capacity = max(1, int(capacity_factor * T * k / E))
    flat = idx.reshape(-1)                                         # (T*k,)
    onehot = torch.arange(E, device=x.device)[:, None] == flat     # (E, T*k)
    # an assignment's slot: the assignments to its expert before it. The
    # scan runs along the flat order, the contiguous axis: along the other
    # (T*k rows of E columns) each of its E threads would walk all T*k rows
    pos = onehot.cumsum(1, dtype=torch.int32).gather(0, flat[None])[0] - 1
    keep = pos < capacity
    slot = flat * capacity + pos.clamp(max=capacity - 1)
    buf = xt.new_zeros((E * capacity + 1, d))
    buf[torch.where(keep, slot, E * capacity)] = xt[:, None].expand(T, k, d).reshape(T * k, d)
    hidden = buf[:-1].view(E, capacity, d)
    up = torch.bmm(hidden, p["w_up"]).view(E * capacity, -1)
    if cfg.mlp_gated:
        gated = gelu_mul if cfg.activation == "gelu" else silu_mul
        h = gated(torch.bmm(hidden, p["w_gate"]).view(E * capacity, -1), up)
    else:
        h = gelu(up)
    out = torch.bmm(h.view(E, capacity, -1), p["w_down"]).view(E * capacity, d)
    terms = out[slot].float() * torch.where(keep, gate.reshape(-1), 0.0)[:, None]
    y = terms.view(T, k, d).sum(1).to(x.dtype)
    if not with_aux:
        return y.view(B, S, d), None
    aux = E * torch.sum(probs.mean(0) * onehot.sum(1) / (T * k))
    return y.view(B, S, d), aux


__all__ = ["NEG_INF", "Params", "rms_norm", "layer_norm", "norm_init",
           "apply_norm", "rope_frequencies", "rope_tables", "rotate",
           "apply_rope", "sinusoidal_positions", "flash_attention",
           "attention_reference", "attn_init", "attn_qkv", "attn_out",
           "mlp_init", "mlp_apply", "moe_init", "moe_route", "moe_apply"]
